"""A whole ``MAMDRStrategy.run()`` of the port vs the JAX package's, the
checkpoint files between the two, and the configurations the port refuses.

- ``run()``: 3 epochs (train with the merged validation, early stop and best
  snapshot after each), test with the best weights, then the SGD finetune
  stage; patience 2, dropout off, at most ``batch_size`` train rows a domain
  (the JAX package shuffles with its own PRNG: one batch a domain is the same
  rows on both sides). Same data, parameters and specific weights
  (tests/test_torch_eval.py ``make_pair``); the numpy draws (domain order,
  support domains) agree bit for bit. Per-domain test loss within rtol 1e-4
  and AUC within abs 1e-5: three epochs of flat Adam amplify last-bit
  gradient differences of near-zero elements to steps of order lr (the DR
  tests' finding), which moves a probability by about 1e-7;
- an npz the port writes (the best params, the MAMDR decomposition) is read
  back by the JAX package's ``load_pytree`` / ``load_decomposition``, and one
  the JAX package writes by the port's ``load_pytree``;
- every configuration whose path is not ported raises NotImplementedError
  naming its ROADMAP item (those the CLI refuses: tests/test_torch_cli.py);
  one whose path has since been ported runs to its result.
"""

import json
import os

import jax
import numpy as np
import pytest

from mamdr_tpu.train import checkpoints as jcheckpoints
from mamdr_tpu_torch.config import ExperimentConfig
from mamdr_tpu_torch.data.synthetic import make_synthetic_dataset
from mamdr_tpu_torch.strategies.base import build_strategy
from mamdr_tpu_torch.strategies.mamdr import MAMDRStrategy
from mamdr_tpu_torch.strategies.meta_base import MetaStrategy
from mamdr_tpu_torch.train import checkpoints
from mamdr_tpu_torch.train.trainer import Trainer
from mamdr_tpu_torch.utils import trees
from test_torch_eval import make_pair


def _trees_equal(port_tree, jax_tree):
    named = dict(zip(trees.param_names(jax.device_get(jax_tree)),
                     jax.tree_util.tree_leaves(jax_tree)))
    assert sorted(named) == trees.param_names(port_tree)
    for name, leaf in trees.leaves_with_names(port_tree):
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(named[name]), err_msg=name)


@pytest.mark.parametrize("long_tail,emb_trainable", [(True, False), (False, True)])
def test_run_matches_jax(tmp_path, long_tail, emb_trainable):
    jt, js, tt, ts = make_pair(tmp_path, long_tail, emb_trainable, n_per_domain=100, batch=64,
                               epoch=3)
    assert max(tt.steps_per_domain()) == 1
    jres, tres = js.run(), ts.run()
    _, _, jdl, jda = jres
    _, _, tdl, tda = tres
    np.testing.assert_allclose([tdl[k] for k in jdl], [jdl[k] for k in jdl], rtol=1e-4)
    np.testing.assert_allclose([tda[k] for k in jda], [jda[k] for k in jda], rtol=0, atol=1e-5)
    assert tt.stopper.best_metric == pytest.approx(jt.stopper.best_metric, abs=1e-5)
    assert tt.stopper.counter == jt.stopper.counter
    # one val event an epoch, then the test and finetune evals
    with open(os.path.join(tt.checkpoint_dir, "metrics.jsonl")) as f:
        events = [json.loads(line)["event"] for line in f]
    with open(os.path.join(jt.checkpoint_dir, "metrics.jsonl")) as f:
        assert events == [json.loads(line)["event"] for line in f]
    assert events.count("val_eval") >= 2 and events[-1] == "test_eval"
    assert os.path.exists(os.path.join(tt.checkpoint_dir, "decomposition", "meta.json"))


def test_port_checkpoints_read_by_jax(tmp_path):
    jt, js, tt, ts = make_pair(tmp_path)
    ts.save_best()  # the best params and the decomposition, as after an improving epoch
    _trees_equal(tt.state.params,
                 jcheckpoints.load_pytree(tt.checkpoint_path, jt.state.params))
    shared, specific, meta = jcheckpoints.load_decomposition(
        tt.checkpoint_dir + "/decomposition", jt.state.params)
    assert meta == {"n_domain": 3, "masked_only": True, "merged_method": "plus"}
    _trees_equal(ts.best_shared, shared)
    for d in range(3):
        _trees_equal(ts.best_specific[d], specific[d])
    with np.load(tt.checkpoint_dir + "/decomposition/specific_0.npz") as z:
        assert not any("user_emb" in k or "item_emb" in k for k in z.files)  # masked only


def test_jax_checkpoints_read_by_port(tmp_path):
    jt, js, tt, ts = make_pair(tmp_path)
    jt.save_checkpoint()
    _trees_equal(checkpoints.load_pytree(jt.checkpoint_path, tt.state.params), jt.state.params)
    tt.save_checkpoint()
    assert tt.best_params is tt.state.params
    for a, b in zip(trees.leaves(tt.load_checkpoint()), trees.leaves(tt.state.params)):
        assert np.array_equal(a.numpy(), b.numpy())
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoints.load_pytree(tt.checkpoint_path, trees.tree_map(
            lambda x: x[:1] if x.dim() else x, tt.state.params))


REFUSED = [
    # lifted: the per-call loops run them (item None: the run must succeed)
    ({"model": "mlp_meta_mamdr_batch_finetune"}, None, "train"),
    ({"train": {"finetune_every_epoch": True}}, None, "train"),
    ({"train": {"target_domain": 1}}, None, "train"),
    ({"dataset": {"fixed_train": True}}, None, "trainer"),
    ({"train": {"meta_finetune_step": 1}}, None, "strategy"),
    ({"train": {"separate_fused": False}}, None, "strategy"),
    # lifted: TensorBoard and the chunked DR lanes (item None: the run must succeed)
    ({"train": {"tensorboard": True}}, None, "trainer"),
    ({"train": {"histogram_freq": 1}}, None, "trainer"),
    ({"train": {"dr_lane_chunk": 2}}, None, "prepare"),
    # lifted: the per-call loops run them (item None: the run must succeed)
    ({"model": "mlp_meta_maml", "train": {"average_meta_grad": "drop"}}, None, "train"),
    ({"model": "mlp_pcgrad", "train": {"target_domain": 1}}, None, "train"),
    # lifted: the autograd lane step runs them (item None: the run must succeed)
    ({"model": "mlp_uncertainty_weight_finetune"}, None, "strategy"),
    ({"model": "mlp_meta_mldg_finetune", "train": {"target_domain": 0}}, None, "train"),
    ({"model": "mlp_meta_domain_negotiation_finetune", "train": {"target_domain": 1}},
     None, "train"),
    ({"model": "mlp_meta_reptile_finetune", "train": {"target_domain": 0}}, None, "train"),
    ({"model": "deepfm"}, None, "trainer"),
    ({"model": "star"}, None, "trainer"),
    # lifted: bf16 towers and the per-leaf Adam (item None: the run must succeed)
    ({"model": "mlp", "compute_dtype": "bfloat16"}, None, "trainer"),
    ({"train": {"flat_optimizer": False}}, None, "trainer"),
]


@pytest.mark.parametrize("change,item,where", REFUSED)
def test_unported_configurations_raise(tmp_path, change, item, where):
    """Each refused configuration raises naming its item; a case whose item
    is None was refused before its path was ported and now runs."""
    d = {"model": {"name": "mlp_meta_mamdr_finetune", "user_dim": 4, "item_dim": 4,
                   "domain_dim": 4, "hidden_dim": [8], "dropout": 0.0},
         "train": {"checkpoint_path": str(tmp_path), "epoch": 1, **change.get("train", {})},
         "dataset": {"name": "synthetic", "batch_size": 16, **change.get("dataset", {})}}
    if "model" in change:
        d["model"]["name"] = change["model"]
    if "compute_dtype" in change:
        d["model"]["compute_dtype"] = change["compute_dtype"]
    cfg = ExperimentConfig.from_dict(d)
    ds = make_synthetic_dataset(n_domain=2, n_uid=10, n_pid=10, n_per_domain=64,
                                batch_size=16)
    if item is None:
        strat = build_strategy(Trainer(cfg, ds, device="cpu", verbose=False))
        avg_loss, avg_auc, dl, da = strat.run()
        assert sorted(dl) == sorted(da) == ["0", "1"]
        assert np.isfinite(avg_loss) and all(0.0 <= v <= 1.0 for v in da.values())
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md, open items §1: {item}"):
        t = Trainer(cfg, ds, device="cpu", verbose=False)
        strat = build_strategy(t)
        if where == "prepare":
            strat.prepare_fused()
        strat.run()
    assert where != "train" or isinstance(strat, MetaStrategy)


def test_build_strategy_runs_mamdr_on_the_cpu(tmp_path):
    cfg = ExperimentConfig.from_dict({
        "model": {"name": "mlp_meta_mamdr_finetune", "user_dim": 4, "item_dim": 4,
                  "domain_dim": 4, "hidden_dim": [8], "dropout": 0.5},
        "train": {"checkpoint_path": str(tmp_path), "epoch": 2, "metrics_jsonl": False},
        "dataset": {"name": "synthetic", "batch_size": 16}})
    ds = make_synthetic_dataset(n_domain=2, n_uid=10, n_pid=10, n_per_domain=64,
                                batch_size=16)
    strat = build_strategy(Trainer(cfg, ds, device="cpu", verbose=False))
    assert isinstance(strat, MAMDRStrategy)
    avg_loss, avg_auc, dl, da = strat.run()
    assert sorted(dl) == sorted(da) == ["0", "1"]
    assert np.isfinite(avg_loss) and all(0.0 <= v <= 1.0 for v in da.values())
    assert sorted(f for f in os.listdir(strat.trainer.checkpoint_dir)) == [
        "decomposition", "domain_0.npz", "domain_1.npz", "model_parameters.npz"]
