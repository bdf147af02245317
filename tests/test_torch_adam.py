"""``train.flat_optimizer: false`` vs the JAX package's
``make_optimizer(flat=False)`` (``optax.adam``; with frozen tables
``optax.chain(masked(set_to_zero), masked(adam))``), in steps, in the
lanes, in runs and in the resume snapshot. The port runs its flat Adam
either way and keeps only the optax state's layout for the snapshot
(``FlatAdam.optax_path`` / ``to_optax`` / ``from_optax``).

- Four steps on the same random gradients: the port's params, ``mu`` and
  ``nu`` against optax's at rtol 1e-6 (the tolerance at which the JAX
  package holds its flat Adam to optax.adam, tests/test_strategy_ops.py:
  optax scales by -lr after dividing, the port before), the counts equal,
  no slot at a frozen leaf (``convert.adam_state_from_jax`` ravels optax's
  state, ``MaskedNode`` leaves left out); ``to_optax`` names and shapes
  every slot leaf as the optax state does, and ``from_optax`` inverts it
  bit for bit;
- ``flat_optimizer`` false gives the flat Adam's bits, for one tower and
  for a lane-stacked state (count [L]), through the train step's all-pad
  gate;
- a whole MAMDR ``run()`` (DN, the DR lanes, the finetune lanes, evals)
  and a joint ``run()`` with ``flat_optimizer`` false equal the same runs
  with it true, bit for bit, frozen and trainable tables;
- the resume snapshot of a per-leaf Adam state: the port's file read by the
  JAX package's ``load_pytree`` with its own state as the template (the
  optax chain's leaf names), and the JAX package's ``save_train_state``
  file read by the port's ``load_pytree``; and the port's own round trip
  through ``save_resume_state`` / ``try_resume``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mamdr_tpu.config import ExperimentConfig as JConfig
from mamdr_tpu.data.synthetic import make_synthetic_dataset as jax_make_synthetic
from mamdr_tpu.train import checkpoints as jcheckpoints
from mamdr_tpu.train.steps import make_optimizer as jax_make_optimizer
from mamdr_tpu.train.trainer import Trainer as JTrainer
from mamdr_tpu.utils import trees as jtrees
from mamdr_tpu_torch.config import ExperimentConfig
from mamdr_tpu_torch.convert import adam_state_from_jax, params_from_jax
from mamdr_tpu_torch.data.synthetic import make_synthetic_dataset
from mamdr_tpu_torch.strategies.base import build_strategy
from mamdr_tpu_torch.train import checkpoints
from mamdr_tpu_torch.train.flat_optimizer import apply_updates
from mamdr_tpu_torch.train.steps import StepConfig, make_optimizer, make_train_step
from mamdr_tpu_torch.train.trainer import Trainer
from mamdr_tpu_torch.utils import trees

FROZEN = ("user_emb", "item_emb")


def _params(rng):
    return {"model": {
        "dnn": {"Dense_0": {"Dense_0": {"kernel": rng.normal(size=(6, 4)).astype(np.float32),
                                        "bias": rng.normal(size=(4,)).astype(np.float32)}}},
        "embedding": {"user_emb": rng.normal(size=(9, 3)).astype(np.float32),
                      "item_emb": rng.normal(size=(7, 3)).astype(np.float32),
                      "domain_emb": rng.normal(size=(2, 3)).astype(np.float32)}}}


def _close(port_tree, jax_tree, what, rtol=1e-6):
    jn = dict(zip(jtrees.param_names(jax_tree), jax.tree_util.tree_leaves(jax_tree)))
    assert trees.param_names(port_tree) == sorted(jn) == list(jn), what
    for n, x in trees.leaves_with_names(port_tree):
        np.testing.assert_allclose(x.numpy(), np.asarray(jn[n]), rtol=rtol, atol=1e-12,
                                   err_msg=f"{what}: {n}")


@pytest.mark.parametrize("emb_trainable", [True, False])
def test_per_leaf_adam_matches_optax(emb_trainable):
    rng = np.random.default_rng(3)
    p0 = _params(rng)
    jtx = jax_make_optimizer("adam", 1e-2, jax.tree_util.tree_map(jnp.asarray, p0),
                             emb_trainable, flat=False)
    ttx = make_optimizer("adam", 1e-2, params_from_jax(p0), emb_trainable, flat=False)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, p0), params_from_jax(p0)
    js, ts = jtx.init(jp), ttx.init(tp)
    for _ in range(4):
        g = jax.tree_util.tree_map(lambda x: rng.normal(size=x.shape).astype(np.float32), p0)
        ju, js = jtx.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tg = trees.named_tree_map(
            lambda n, x: None if not emb_trainable and n.endswith(FROZEN) else
            torch.from_numpy(x), g)
        tu, ts = ttx.update(tg, ts)
        tp = apply_updates(tp, tu)
    _close(tp, jax.device_get(jp), "params")
    want = adam_state_from_jax(jax.device_get(js), emb_trainable)
    assert int(ts.count) == int(want.count) == 4
    for slot in ("mu", "nu"):
        np.testing.assert_allclose(getattr(ts, slot).numpy(), getattr(want, slot).numpy(),
                                   rtol=1e-6, err_msg=slot)
    # the snapshot layout: optax's leaf names and shapes, frozen leaves absent
    optax_tree = ttx.to_optax(ts, tp)
    jleaves = [(n, x) for n, x in zip(jtrees.param_names(jax.device_get(js)),
                                      jax.tree_util.tree_leaves(jax.device_get(js)))]
    assert trees.param_names(optax_tree) == [n for n, _ in jleaves]
    for (n, x), (_, y) in zip(trees.leaves_with_names(optax_tree), jleaves):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6, err_msg=n)
    names = trees.param_names(optax_tree)
    assert any(n.endswith(FROZEN) for n in names) == emb_trainable
    back = ttx.from_optax(optax_tree)
    assert all(torch.equal(a, b) for a, b in zip(back, ts))
    if not emb_trainable:  # frozen leaves: no slot, no update
        for n in ("user_emb", "item_emb"):
            np.testing.assert_array_equal(tp["model"]["embedding"][n].numpy(),
                                          p0["model"]["embedding"][n])


@pytest.mark.parametrize("lanes", [None, 3])
def test_per_leaf_adam_gives_the_flat_adams_bits(lanes):
    """``flat`` false vs true through the train step (the all-pad gate
    included), one tower or a lane-stacked state whose lane 1 sees an
    all-pad batch."""
    from mamdr_tpu_torch.models.deepctr import MLP
    from mamdr_tpu_torch.train.state import TrainState

    model = MLP(20, 30, 2, 4, 4, 4, (8,), 0.0, generator=torch.Generator().manual_seed(0))
    params = {"model": model.param_tree()}
    cfg = StepConfig(emb_trainable=False)
    rng = np.random.default_rng(1)
    shape = (12,) if lanes is None else (lanes, 12)
    batches = [{"uid": torch.from_numpy(rng.integers(0, 20, shape).astype(np.int32)),
                "pid": torch.from_numpy(rng.integers(0, 30, shape).astype(np.int32)),
                "domain": torch.ones(shape, dtype=torch.int32),
                "label": torch.from_numpy(rng.integers(0, 2, shape).astype(np.float32)),
                "weight": torch.ones(shape)} for _ in range(3)]
    if lanes is not None:
        for b in batches:
            b["weight"][1] = 0.0
    out = []
    for flat in (True, False):
        tx = make_optimizer("adam", 1e-2, params, False, flat=flat)
        state = TrainState.create(params, tx.init(params), 7, "cpu")
        if lanes is not None:
            lane = lambda x: x.expand(lanes, *x.shape)  # noqa: E731
            state = state.replace(
                params=trees.named_tree_map(
                    lambda n, x: x if n.endswith(FROZEN) else lane(x).contiguous(), params),
                opt_state=type(state.opt_state)(*(lane(x) for x in state.opt_state)),
                seed=torch.arange(lanes), step=lane(state.step))
        step = make_train_step(model, tx, cfg)
        for b in batches:
            state, _ = step(state, b)
        out.append(state)
    flat_s, leaf_s = out
    assert torch.equal(flat_s.step, leaf_s.step)
    for a, b in zip(trees.leaves(flat_s.params), trees.leaves(leaf_s.params)):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(flat_s.opt_state, leaf_s.opt_state))
    if lanes is not None:  # the all-pad lane kept its count
        assert leaf_s.opt_state.count.tolist() == [3, 0, 3]


def _config(tmp_path, name, emb_trainable, flat):
    return {
        "model": {"name": name, "user_dim": 8, "item_dim": 8, "domain_dim": 8,
                  "hidden_dim": [16, 8], "dropout": 0.3},
        "train": {"epoch": 2, "learning_rate": 0.01, "patience": 5, "sample_num": 1,
                  "meta_learning_rate": 0.1, "load_pretrain_emb": True,
                  "emb_trainable": emb_trainable, "flat_optimizer": flat,
                  "checkpoint_path": str(tmp_path / str(flat) / "ckpt"),
                  "result_save_path": str(tmp_path / str(flat) / "result")},
        "dataset": {"name": "synthetic", "batch_size": 64, "seed": 5},
    }


def _dataset(make=make_synthetic_dataset):
    ds = make(n_domain=3, n_uid=50, n_pid=50, n_per_domain=300, seed=5, batch_size=64)
    r = np.random.default_rng(0)
    ds.user_emb = r.normal(0, 0.1, (50, 8)).astype(np.float32)
    ds.item_emb = r.normal(0, 0.1, (50, 8)).astype(np.float32)
    return ds


@pytest.mark.parametrize("emb_trainable", [False, True])
@pytest.mark.parametrize("name", ["mlp_meta_mamdr_finetune", "mlp"])
def test_run_with_per_leaf_adam_equals_flat(tmp_path, name, emb_trainable):
    runs = []
    for flat in (True, False):
        cfg = ExperimentConfig.from_dict(_config(tmp_path, name, emb_trainable, flat))
        strat = build_strategy(Trainer(cfg, _dataset(), device="cpu", verbose=False))
        runs.append((strat, strat.run()))
    (sf, rf), (sl, rl) = runs
    assert sf.trainer.tx.optax_path is None
    assert sl.trainer.tx.optax_path == (("0",) if emb_trainable else ("1", "inner_state", "0"))
    if name.startswith("mlp_meta_mamdr"):
        assert sl.dr_lanes
    assert rf == rl
    for a, b in zip(trees.leaves(sf.trainer.state.params), trees.leaves(sl.trainer.state.params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("emb_trainable", [False, True])
def test_resume_snapshot_read_both_ways(tmp_path, emb_trainable):
    cfg = ExperimentConfig.from_dict(_config(tmp_path, "mlp", emb_trainable, False))
    t = Trainer(cfg, _dataset(), device="cpu", verbose=False)
    t.state, _ = t.fit_domain(t.state, 0)
    assert int(t.state.opt_state.count) > 0
    t.save_resume_state(0)

    jcfg = JConfig.from_dict(_config(tmp_path / "jax", "mlp", emb_trainable, False))
    jt = JTrainer(jcfg, _dataset(jax_make_synthetic), verbose=False)
    tmpl = {"params": jt.state.params, "opt_state": jt.state.opt_state,
            "batch_stats": jt.state.batch_stats, "step": jt.state.step}
    loaded = jcheckpoints.load_pytree(f"{t.resume_dir}/train_state.npz", tmpl)
    got = adam_state_from_jax(jax.device_get(loaded["opt_state"]), emb_trainable)
    assert all(torch.equal(a, b) for a, b in zip(got, t.state.opt_state))
    assert int(loaded["step"]) == int(t.state.step)

    # the JAX package's snapshot, read by the port
    jt.state = jt.state.replace(params=loaded["params"], opt_state=loaded["opt_state"],
                                step=loaded["step"])
    jcheckpoints.save_train_state(str(tmp_path / "jres"), jt.state, 0, jt.stopper, jt.np_rng)
    fresh = Trainer(cfg, _dataset(), device="cpu", verbose=False)
    snap = fresh._snapshot_layout(fresh.state)
    ptmpl = {"params": snap.params, "opt_state": snap.opt_state,
             "batch_stats": snap.batch_stats, "step": snap.step}
    back = checkpoints.load_pytree(str(tmp_path / "jres" / "train_state.npz"), ptmpl)
    for a, b in zip(trees.leaves(back["params"]), trees.leaves(t.state.params)):
        assert torch.equal(a, b)
    opt = fresh.tx.from_optax(back["opt_state"])
    assert all(torch.equal(a, b) for a, b in zip(opt, t.state.opt_state))

    # the port's own round trip
    cfg.train.resume = True
    t2 = Trainer(cfg, _dataset(), device="cpu", verbose=False)
    assert t2.try_resume() is not None
    assert all(torch.equal(a, b) for a, b in zip(t2.state.opt_state, t.state.opt_state))
