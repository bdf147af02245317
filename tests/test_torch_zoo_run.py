"""Whole ``run()``s of the zoo's single-tower models (WDL, DeepFM, NFM,
AutoInt, CCPM, PNN) in the port vs the JAX package's.

The recipe of tests/test_torch_run.py and tests/test_torch_strategies.py:
3 domains, 3 epochs with patience 2, dropout off, at most ``batch_size``
train rows a domain (the JAX package shuffles with its own PRNG, so one batch
a domain is the same rows on both sides), the same start parameters
(``convert.params_from_jax``), frozen and trainable tables, balanced and
long-tailed data. Per-domain test loss within rtol 1e-4 and AUC within abs
1e-5 (flat Adam turns last-bit gradient differences into steps of order lr);
the early stop's state, the numpy draws and the ``metrics.jsonl`` events
equal. The port's steps take autograd through K2's plain version here.
``zoo_pair`` and ``run_and_compare`` are shared with
tests/test_torch_zoo_mtl_run.py and tests/test_torch_zoo_lanes_run.py.
"""

import jax
import numpy as np
import pytest
import torch

from mamdr_tpu.config import ExperimentConfig as JConfig
from mamdr_tpu.data.synthetic import make_synthetic_dataset as jax_make_synthetic
from mamdr_tpu.strategies import build_strategy as jbuild_strategy
from mamdr_tpu.train.trainer import Trainer as JTrainer
from mamdr_tpu_torch.config import ExperimentConfig
from mamdr_tpu_torch.convert import params_from_jax, specific_from_jax
from mamdr_tpu_torch.data.synthetic import make_synthetic_dataset
from mamdr_tpu_torch.strategies.base import build_strategy
from mamdr_tpu_torch.strategies.joint import JointStrategy
from mamdr_tpu_torch.strategies.mamdr import MAMDRStrategy
from mamdr_tpu_torch.train.trainer import Trainer
from mamdr_tpu_torch.utils import trees
from test_torch_strategies import events, results_close
from test_torch_zoo import model_dict

SINGLE_TOWER = ["wdl", "deepfm", "nfm", "autoint", "ccpm", "pnn"]


def zoo_pair(tmp_path, name, long_tail=False, emb_trainable=False, batch=64, **train):
    """(JAX trainer, JAX strategy, port trainer, port strategy) for model
    `name` on the same data, parameters and (MAMDR) specific weights."""
    def config(side):
        return {
            "model": model_dict(name),
            "train": {"load_pretrain_emb": True, "emb_trainable": emb_trainable,
                      "learning_rate": 1e-2, "meta_learning_rate": 0.1, "sample_num": 2,
                      "epoch": 3, "patience": 2,
                      "checkpoint_path": str(tmp_path / side / "ckpt"),
                      "result_save_path": str(tmp_path / side / "result"), **train},
            "dataset": {"name": "synthetic", "batch_size": batch, "seed": 21},
        }

    kw = dict(n_domain=3, n_uid=50, n_pid=60, n_per_domain=100, seed=21,
              long_tail=long_tail, batch_size=batch)
    jds, tds = jax_make_synthetic(**kw), make_synthetic_dataset(**kw)
    for ds in (jds, tds):
        rng = np.random.default_rng(0)
        ds.user_emb = rng.normal(0, 0.1, (50, 8)).astype(np.float32)
        ds.item_emb = rng.normal(0, 0.1, (60, 8)).astype(np.float32)
    jt = JTrainer(JConfig.from_dict(config("jax")), jds, verbose=False)
    js = jbuild_strategy(jt)
    tt = Trainer(ExperimentConfig.from_dict(config("port")), tds, device="cpu", verbose=False)
    tt.state = tt.state.replace(params=params_from_jax(jax.device_get(jt.state.params)))
    ts = build_strategy(tt)
    if isinstance(ts, MAMDRStrategy):
        ts.specific = specific_from_jax(jax.device_get(js.specific), ts.mask, ts.shared)
        ts.best_specific = list(ts.specific)
    return jt, js, tt, ts


def run_and_compare(pair, emb_trainable):
    """Run both strategies of a ``zoo_pair`` and hold the port to the JAX
    package; frozen tables stay the same tensors, some weight moves."""
    jt, js, tt, ts = pair
    assert max(tt.steps_per_domain()) == 1
    params0 = tt.state.params
    jres, tres = js.run(), ts.run()
    results_close(tres, jres)
    assert tt.stopper.best_metric == pytest.approx(jt.stopper.best_metric, abs=1e-5)
    assert (tt.stopper.counter, tt.stopper.early_stop) == (jt.stopper.counter,
                                                           jt.stopper.early_stop)
    assert tt.np_rng.bit_generator.state == jt.np_rng.bit_generator.state
    assert events(tt) == events(jt)
    best = tt.best_params if tt.best_params is not None else tt.state.params
    moved = []
    for (n, x), x0 in zip(trees.leaves_with_names(best), trees.leaves(params0)):
        if not emb_trainable and ("user_emb" in n or "item_emb" in n):
            assert x is x0, n  # frozen tables, the linear ones too, are the same tensors
        else:
            moved.append(not torch.equal(x, x0))
    assert any(moved)
    return jt, js, tt, ts


@pytest.mark.parametrize("long_tail,emb_trainable", [(True, False), (False, True)])
@pytest.mark.parametrize("name", SINGLE_TOWER)
def test_joint_run_matches_jax(tmp_path, name, long_tail, emb_trainable):
    _, _, _, ts = run_and_compare(zoo_pair(tmp_path, name, long_tail, emb_trainable),
                                  emb_trainable)
    assert type(ts) is JointStrategy
