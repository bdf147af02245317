"""The port's joint, separate, finetune, Domain-Negotiation and Reptile
strategies vs the JAX package's.

- ``run()`` of ``mlp`` (joint), ``mlp_separate``, ``mlp_finetune``,
  ``mlp_meta_domain_negotiation_finetune`` and ``mlp_meta_reptile_finetune``
  (per-domain and batch updates), 3 epochs with patience 2, frozen and
  trainable tables, balanced and long-tailed data. Both packages start from
  the same parameters (``convert.params_from_jax``), dropout off, at most
  ``batch_size`` train rows a domain: the JAX package shuffles rows with its
  own PRNG, so one batch a domain holds the same rows on both sides. The
  numpy draws (domain order) agree bit for bit. Per-domain test loss within
  rtol 1e-4, AUC within abs 1e-5 (flat Adam turns last-bit gradient
  differences of near-zero elements into steps of order lr; a probability
  then moves by about 1e-7); the early stop's state equal; the
  ``metrics.jsonl`` event lists equal;
- one epoch of ``make_fused_passes``, ``make_fused_dn`` and
  ``make_fused_reptile`` (with and without a step cap, per-domain and batch)
  from the same state against the JAX functions with ``shuffle=False``,
  several batches a domain: params and meta within rtol 2e-5 / atol 1e-5;
- the weight-space ops of batch Reptile (``delta_accumulate``,
  ``scaled_add``) equal the JAX package's.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from mamdr_tpu.config import ExperimentConfig as JConfig
from mamdr_tpu.data.synthetic import make_synthetic_dataset as jax_make_synthetic
from mamdr_tpu.strategies import build_strategy as jbuild_strategy
from mamdr_tpu.strategies import ops as jops
from mamdr_tpu.train import fused as jfused
from mamdr_tpu.train.trainer import Trainer as JTrainer
from mamdr_tpu_torch.config import ExperimentConfig
from mamdr_tpu_torch.convert import params_from_jax
from mamdr_tpu_torch.data.synthetic import make_synthetic_dataset
from mamdr_tpu_torch.strategies import ops
from mamdr_tpu_torch.strategies.base import build_strategy
from mamdr_tpu_torch.strategies.domain_negotiation import DomainNegotiationStrategy
from mamdr_tpu_torch.strategies.joint import JointStrategy
from mamdr_tpu_torch.strategies.reptile import ReptileStrategy
from mamdr_tpu_torch.train import fused
from mamdr_tpu_torch.train.trainer import Trainer
from mamdr_tpu_torch.utils import trees

STRATEGIES = [
    ("mlp", JointStrategy),
    ("mlp_separate", JointStrategy),
    ("mlp_finetune", JointStrategy),
    ("mlp_meta_domain_negotiation_finetune", DomainNegotiationStrategy),
    ("mlp_meta_reptile_finetune", ReptileStrategy),
    ("mlp_meta_reptile_batch_finetune", ReptileStrategy),
]


def config_dict(root, name, emb_trainable=False, batch=64, epoch=3, **train):
    return {
        "model": {"name": name, "user_dim": 8, "item_dim": 8, "domain_dim": 8,
                  "hidden_dim": [32, 16], "dropout": 0.0},
        "train": {"load_pretrain_emb": True, "emb_trainable": emb_trainable,
                  "learning_rate": 1e-2, "meta_learning_rate": 0.1, "epoch": epoch,
                  "patience": 2, "checkpoint_path": str(root / "ckpt"),
                  "result_save_path": str(root / "result"), **train},
        "dataset": {"name": "synthetic", "batch_size": batch, "seed": 21},
    }


def make_strategy_pair(tmp_path, name, long_tail=False, emb_trainable=False, n_domain=3,
                       n_per_domain=100, batch=64, epoch=3, **train):
    """(JAX trainer, JAX strategy, port trainer, port strategy) for model
    `name` on the same data and parameters; dropout off."""
    kw = dict(n_domain=n_domain, n_uid=50, n_pid=60, n_per_domain=n_per_domain, seed=21,
              long_tail=long_tail, batch_size=batch)
    jds, tds = jax_make_synthetic(**kw), make_synthetic_dataset(**kw)
    for ds in (jds, tds):
        rng = np.random.default_rng(0)
        ds.user_emb = rng.normal(0, 0.1, (50, 8)).astype(np.float32)
        ds.item_emb = rng.normal(0, 0.1, (60, 8)).astype(np.float32)
    args = dict(emb_trainable=emb_trainable, batch=batch, epoch=epoch, **train)
    jt = JTrainer(JConfig.from_dict(config_dict(tmp_path / "jax", name, **args)), jds,
                  verbose=False)
    js = jbuild_strategy(jt)
    tt = Trainer(ExperimentConfig.from_dict(config_dict(tmp_path / "port", name, **args)),
                 tds, device="cpu", verbose=False)
    tt.state = tt.state.replace(params=params_from_jax(jax.device_get(jt.state.params)))
    return jt, js, tt, build_strategy(tt)


def results_close(tres, jres):
    _, _, tdl, tda = tres
    _, _, jdl, jda = jres
    assert sorted(tdl) == sorted(jdl) == sorted(tda) == sorted(jda)
    np.testing.assert_allclose([tdl[k] for k in jdl], [jdl[k] for k in jdl], rtol=1e-4)
    np.testing.assert_allclose([tda[k] for k in jda], [jda[k] for k in jda], rtol=0, atol=1e-5)
    assert all(0.0 <= v <= 1.0 for v in tda.values())


def events(trainer):
    path = os.path.join(trainer.checkpoint_dir, "metrics.jsonl")
    with open(path) as f:
        return [json.loads(line)["event"] for line in f]


@pytest.mark.parametrize("long_tail,emb_trainable", [(True, False), (False, True)])
@pytest.mark.parametrize("name,cls", STRATEGIES)
def test_run_matches_jax(tmp_path, name, cls, long_tail, emb_trainable):
    jt, js, tt, ts = make_strategy_pair(tmp_path, name, long_tail, emb_trainable)
    assert type(ts) is cls and max(tt.steps_per_domain()) == 1
    params0 = tt.state.params
    jres, tres = js.run(), ts.run()
    results_close(tres, jres)
    assert tt.stopper.best_metric == pytest.approx(jt.stopper.best_metric, abs=1e-5)
    assert (tt.stopper.counter, tt.stopper.early_stop) == (jt.stopper.counter,
                                                           jt.stopper.early_stop)
    assert tt.np_rng.bit_generator.state == jt.np_rng.bit_generator.state
    assert events(tt) == events(jt)
    if name == "mlp_separate":
        assert events(tt) == ["test_eval"]  # the lanes' one summary
        return
    assert events(tt).count("val_eval") >= 2
    if name == "mlp":
        assert events(tt).count("train_epoch") == events(tt).count("val_eval")
    if isinstance(ts, (DomainNegotiationStrategy, ReptileStrategy)):
        # meta moved only on its masked leaves; frozen tables are the same tensors
        for (n, m), a, b in zip(trees.leaves_with_names(ts.mask), trees.leaves(ts.meta),
                                trees.leaves(params0)):
            assert m != torch.equal(a, b), n
            if not m and not emb_trainable:
                assert a is b, n


def _jnamed(tree):
    return dict(zip(trees.param_names(jax.device_get(tree)), jax.tree_util.tree_leaves(tree)))


def _trees_close(ttree, jtree, what):
    jn = _jnamed(jtree)
    assert sorted(jn) == trees.param_names(ttree)
    for name, leaf in trees.leaves_with_names(ttree):
        np.testing.assert_allclose(leaf.numpy(), np.asarray(jn[name]), rtol=2e-5, atol=1e-5,
                                   err_msg=f"{what}:{name}")


EPOCHS = [("passes", False, 0), ("dn", False, 0), ("dn", False, 2), ("reptile", False, 0),
          ("reptile", False, 2), ("reptile", True, 0), ("reptile", True, 2)]


@pytest.mark.parametrize("emb_trainable", [False, True])
@pytest.mark.parametrize("kind,batch_mode,cap", EPOCHS)
def test_fused_epoch_matches_jax(tmp_path, kind, batch_mode, cap, emb_trainable):
    """One epoch from the same state, several batches a domain (long-tailed:
    4, 3 and 2 steps), shuffle off on both sides."""
    name = {"passes": "mlp", "dn": "mlp_meta_domain_negotiation",
            "reptile": "mlp_meta_reptile_batch" if batch_mode else "mlp_meta_reptile"}[kind]
    batch = 32
    jt, js, tt, ts = make_strategy_pair(tmp_path, name, True, emb_trainable, n_per_domain=200,
                                        batch=batch, epoch=1)
    assert tt.steps_per_domain() == jt.steps_per_domain() == [4, 3, 2]
    order = np.asarray([2, 0, 1], np.int32)
    jblock, n_steps = jt.train_block()
    tblock, t_steps = tt.train_block()
    assert t_steps == n_steps
    steps = tt.steps_per_domain()
    jstep, tstep = jt.train_step_fn(), tt.train_step_fn()
    key = jax.random.PRNGKey(0)
    if kind == "passes":
        # JAX make_fused_passes always shuffles: its inner pass with shuffle off
        seq = jfused._make_sequential_pass(jstep, n_steps, batch, steps, shuffle=False)
        jstate, jlosses = jax.jit(seq)(jt.state, jblock, order, key)
        tstate, tlosses = fused.make_fused_passes(tstep, t_steps, batch, steps,
                                                  shuffle=False)(tt.state, tblock, order,
                                                                 tt.gen)
        jmeta = tmeta = None
    elif kind == "dn":
        jfn = jfused.make_fused_dn(jstep, js.mask, n_steps, batch, cap_steps=cap,
                                   shuffle=False, steps_list=steps)
        tfn = fused.make_fused_dn(tstep, ts.mask, t_steps, batch, cap_steps=cap,
                                  shuffle=False, steps_list=steps)
        jstate, jmeta, jlosses = jfn(jt.state, jt.state.params, jblock, order, key, 0.1)
        tstate, tmeta, tlosses = tfn(tt.state, tt.state.params, tblock, order, tt.gen, 0.1)
    else:
        jfn = jfused.make_fused_reptile(jstep, js.mask, n_steps, batch, batch_mode,
                                        cap_steps=cap, shuffle=False, steps_list=steps)
        tfn = fused.make_fused_reptile(tstep, ts.mask, t_steps, batch, batch_mode,
                                       cap_steps=cap, shuffle=False, steps_list=steps)
        jstate, jmeta, jlosses = jfn(jt.state, jt.state.params, jblock, order, key, 0.1)
        tstate, tmeta, tlosses = tfn(tt.state, tt.state.params, tblock, order, tt.gen, 0.1)
    run = [min(s, cap) if cap else s for s in steps]
    assert int(tstate.step) == int(jstate.step) == sum(run)
    np.testing.assert_allclose(tlosses.numpy(), np.asarray(jlosses), rtol=2e-5, atol=1e-7)
    _trees_close(tstate.params, jstate.params, "params")
    if tmeta is not None:
        _trees_close(tmeta, jmeta, "meta")
        for (n, m), a, b in zip(trees.leaves_with_names(ts.mask), trees.leaves(tmeta),
                                trees.leaves(tt.state.params)):
            assert m or a is b, n  # unmasked leaves pass through by reference
    np.testing.assert_allclose(tstate.opt_state.mu.numpy(), np.asarray(jstate.opt_state.mu),
                               rtol=2e-5, atol=1e-8)


def test_batch_reptile_ops_match_jax():
    rng = np.random.default_rng(0)
    mk = lambda: {"a": {"k": rng.normal(size=(3, 2)).astype(np.float32)},  # noqa: E731
                  "b": rng.normal(size=4).astype(np.float32)}
    acc, adapted, base = mk(), mk(), mk()
    mask = {"a": {"k": True}, "b": False}
    tacc, tad, tbase = (params_from_jax(x) for x in (acc, adapted, base))
    for jt_, tt_, first in (
        (jops.delta_accumulate(acc, adapted, base, mask),
         ops.delta_accumulate(tacc, tad, tbase, mask), tacc),
        (jops.scaled_add(base, acc, 0.1, mask), ops.scaled_add(tbase, tacc, 0.1, mask), tbase),
    ):
        for (name, leaf), want in zip(trees.leaves_with_names(tt_), trees.leaves(jt_)):
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(want), err_msg=name)
        assert tt_["b"] is first["b"]  # unmasked leaves pass through by reference
