"""The meta-gradient pieces of the port vs the JAX package's, on the CPU.

- ``ops.pcgrad_project`` in both modes (rows of norm 0, rows with dot 0,
  dot of either sign), ``ema_accumulate``, ``tree_add_trees`` and
  ``tree_where_mask_zero`` on the same trees: within 1e-6 relative;
  unmasked leaves pass through by reference;
- ``split_support_query`` in its three modes: index sets and the numpy
  generator's state afterwards bit-equal;
- ``steps.make_accum_grad_fn`` (grads of the total loss at fixed params,
  dropout off under a 0.5-dropout model) and ``fused._grad_epoch_on_flat``
  ("sum" / "ema", step cap 0 / 2, with and without per-domain real step
  counts, onto a non-zero accumulator, frozen and trainable tables): rtol
  2e-5 / atol 1e-5, ``None`` at frozen tables and at leaves outside the
  mask;
- ``MAMLStrategy.accumulate_split``: the same grads and the same numpy
  draws as the JAX one;
- the uncertainty-weighted loss: its data loss and gradients (``log_vars``
  included) by autograd against ``jax.value_and_grad``, the gate that sends
  it there, and the per-domain eval loss of ``Trainer.val_and_test``.

The JAX side runs on the CPU, where its fused kernel is not eligible: its
gradients come from XLA autodiff, as its own CPU tests take them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamdr_tpu.config import ExperimentConfig as JConfig
from mamdr_tpu.data.dataset import split_support_query as jsplit_support_query
from mamdr_tpu.data.synthetic import make_synthetic_dataset as jax_make_synthetic
from mamdr_tpu.strategies import ops as jops
from mamdr_tpu.strategies.maml import MAMLStrategy as JMAML
from mamdr_tpu.train import fused as jfused
from mamdr_tpu.train.trainer import Trainer as JTrainer
from mamdr_tpu_torch.config import ExperimentConfig
from mamdr_tpu_torch.convert import params_from_jax
from mamdr_tpu_torch.data.dataset import DomainSplit, split_support_query
from mamdr_tpu_torch.data.synthetic import make_synthetic_dataset
from mamdr_tpu_torch.ops.fused_mlp_step import make_fast_loss_grad
from mamdr_tpu_torch.strategies import ops
from mamdr_tpu_torch.strategies.maml import MAMLStrategy
from mamdr_tpu_torch.train import fused
from mamdr_tpu_torch.train.steps import (
    StepConfig,
    make_autograd_loss_grad,
    make_loss_grad,
)
from mamdr_tpu_torch.train.trainer import Trainer
from mamdr_tpu_torch.utils import trees


def _tree(rng, shapes):
    return {k: (_tree(rng, v) if isinstance(v, dict)
                else rng.normal(size=v).astype(np.float32)) for k, v in shapes.items()}


SHAPES = {"a": {"k": (5, 4)}, "b": (6,), "c": (3, 1), "d": (2, 3, 4)}


def _edge_rows(gq, ga):
    """Rows the projection must treat exactly: a query row of norm 0, a row
    with dot exactly 0, and rows with dot of either sign."""
    gq["a"]["k"][0] = 0.0
    gq["a"]["k"][1] = [1.0, 0.0, 0.0, 0.0]
    ga["a"]["k"][1] = [0.0, 2.0, -3.0, 4.0]
    ga["a"]["k"][2] = np.abs(gq["a"]["k"][2]) * np.sign(gq["a"]["k"][2])   # dot > 0
    ga["a"]["k"][3] = -np.abs(gq["a"]["k"][3]) * np.sign(gq["a"]["k"][3])  # dot < 0
    gq["c"][1] = 0.0


def _close(ttree, jtree, rtol=1e-6, atol=0.0):
    for (name, leaf), want in zip(trees.leaves_with_names(ttree), jax.tree_util.tree_leaves(jtree)):
        np.testing.assert_allclose(leaf.numpy(), np.asarray(want), rtol=rtol, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("mode", ["reference", "paper"])
def test_pcgrad_project_matches_jax(mode):
    rng = np.random.default_rng(1)
    gq, ga = _tree(rng, SHAPES), _tree(rng, SHAPES)
    _edge_rows(gq, ga)
    want = jops.pcgrad_project(gq, ga, mode)
    got = ops.pcgrad_project(params_from_jax(gq), params_from_jax(ga), mode)
    _close(got, want)
    # the row of norm 0 and the row with dot 0 come back unprojected
    np.testing.assert_array_equal(got["a"]["k"][:2].numpy(), ga["a"]["k"][:2])
    np.testing.assert_array_equal(got["c"][1].numpy(), ga["c"][1])
    # a None leaf (a frozen table's) passes through
    tq, ta = params_from_jax(gq), params_from_jax(ga)
    tq["b"] = ta["b"] = None
    assert ops.pcgrad_project(tq, ta, mode)["b"] is None
    with pytest.raises(ValueError, match="unknown pcgrad mode"):
        ops.pcgrad_project(tq, ta, "other")


def test_ema_add_and_mask_zero_match_jax():
    rng = np.random.default_rng(2)
    acc, g, other = _tree(rng, SHAPES), _tree(rng, SHAPES), _tree(rng, SHAPES)
    mask = {"a": {"k": True}, "b": False, "c": True, "d": False}
    tacc, tg, tother = (params_from_jax(x) for x in (acc, g, other))
    got = ops.ema_accumulate(tacc, tg, mask)
    _close(got, jops.ema_accumulate(acc, g, mask))
    assert got["b"] is tacc["b"] and got["d"] is tacc["d"]
    _close(ops.ema_accumulate(tacc, tg, mask, momentum=0.5),
           jops.ema_accumulate(acc, g, mask, momentum=0.5))
    _close(ops.tree_add_trees(tacc, tother), jops.tree_add_trees(acc, other))
    _close(ops.tree_where_mask_zero(tacc, mask), jops.tree_where_mask_zero(acc, mask))
    tacc["b"] = None
    assert ops.tree_add_trees(tacc, tother)["b"] is None
    assert ops.ema_accumulate(tacc, tg, {**mask, "b": True})["b"] is None


@pytest.mark.parametrize("n", [37, 1])
@pytest.mark.parametrize("mode,ratio", [("train-train", 0.8), ("meta-train/val", 0.2),
                                        ("meta-train/val", 0.8),
                                        ("meta-train/val-no-exclusive", 0.3)])
def test_split_support_query_matches_jax(mode, ratio, n):
    rng = np.random.default_rng(3)
    cols = (rng.integers(0, 50, n).astype(np.int32), rng.integers(0, 60, n).astype(np.int32),
            np.full(n, 2, np.int32), rng.integers(0, 2, n).astype(np.float32))
    from mamdr_tpu.data.dataset import DomainSplit as JSplit

    jrng, trng = np.random.default_rng(7), np.random.default_rng(7)
    js, jq = jsplit_support_query(JSplit(*cols), mode, ratio, jrng)
    ts, tq = split_support_query(DomainSplit(*cols), mode, ratio, trng)
    for a, b in ((ts, js), (tq, jq)):
        for c in ("uid", "pid", "domain", "label"):
            x, y = getattr(a, c), getattr(b, c)
            assert x.dtype == y.dtype and np.array_equal(x, y), c
    assert trng.bit_generator.state == jrng.bit_generator.state
    with pytest.raises(ValueError, match="unknown meta_split"):
        split_support_query(DomainSplit(*cols), "other", ratio, np.random.default_rng(0))


def _config(root, name, emb_trainable, dropout, batch, **train):
    return {
        "model": {"name": name, "user_dim": 8, "item_dim": 8, "domain_dim": 8,
                  "hidden_dim": [32, 16], "dropout": dropout},
        "train": {"load_pretrain_emb": True, "emb_trainable": emb_trainable,
                  "learning_rate": 1e-2, "meta_learning_rate": 1e-2, "epoch": 1,
                  "patience": 2, "checkpoint_path": str(root / "ckpt"),
                  "result_save_path": str(root / "result"), **train},
        "dataset": {"name": "synthetic", "batch_size": batch, "seed": 21},
    }


def trainer_pair(tmp_path, name, emb_trainable=False, dropout=0.0, long_tail=True,
                 n_per_domain=200, batch=32, **train):
    """(JAX trainer, port trainer) for model `name` on the same data and
    parameters."""
    kw = dict(n_domain=3, n_uid=50, n_pid=60, n_per_domain=n_per_domain, seed=21,
              long_tail=long_tail, batch_size=batch)
    jds, tds = jax_make_synthetic(**kw), make_synthetic_dataset(**kw)
    for ds in (jds, tds):
        rng = np.random.default_rng(0)
        ds.user_emb = rng.normal(0, 0.1, (50, 8)).astype(np.float32)
        ds.item_emb = rng.normal(0, 0.1, (60, 8)).astype(np.float32)
    args = (name, emb_trainable, dropout, batch)
    jt = JTrainer(JConfig.from_dict(_config(tmp_path / "jax", *args, **train)), jds,
                  verbose=False)
    tt = Trainer(ExperimentConfig.from_dict(_config(tmp_path / "port", *args, **train)), tds,
                 device="cpu", verbose=False)
    tt.state = tt.state.replace(params=params_from_jax(jax.device_get(jt.state.params)))
    return jt, tt


def _first_batch(jt, tt, dom=0, cut=None):
    jblock, _ = jt.train_block()
    tblock, _ = tt.train_block()
    b = jt.dataset.batch_size
    jb = {k: v[dom, :b] for k, v in jblock.items()}
    tb = {k: v[dom, :b].contiguous() for k, v in tblock.items()}
    if cut is not None:  # a partial batch
        jb["weight"] = jb["weight"].at[cut:].set(0.0)
        tb["weight"][cut:] = 0.0
    return jb, tb


def _grads_close(tgrads, jgrads, mask=None):
    """Port grads (None at frozen tables / outside ``mask``) vs JAX grads."""
    jn = dict(zip(trees.param_names(jax.device_get(jgrads)),
                  jax.tree_util.tree_leaves(jgrads)))
    mask_of = dict(trees.leaves_with_names(mask)) if mask is not None else {}
    for name, leaf in trees.leaves_with_names(tgrads):
        if leaf is None:
            assert (("user_emb" in name or "item_emb" in name) or not mask_of.get(name, True)), name
            continue
        np.testing.assert_allclose(leaf.numpy(), np.asarray(jn[name]), rtol=2e-5, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("emb_trainable", [False, True])
def test_accum_grad_fn_matches_jax(tmp_path, emb_trainable):
    """Grads at fixed params with dropout off, under a 0.5-dropout model, on
    a partial batch: the port's K1 path (its plain version here) at rate 0
    against JAX autodiff at train=False."""
    jt, tt = trainer_pair(tmp_path, "mlp_meta_maml", emb_trainable, dropout=0.5)
    jb, tb = _first_batch(jt, tt, cut=20)
    jg = jt.accum_grad_fn(jt.state.params, jt.state.batch_stats, jb, jax.random.PRNGKey(5))
    tg = tt.accum_grad_fn(tt.state.params, tb)
    _grads_close(tg, jg)
    frozen = [n for n, g in trees.leaves_with_names(tg) if g is None]
    assert frozen == ([] if emb_trainable else ["model/embedding/item_emb",
                                                "model/embedding/user_emb"])
    # dropout off: a second call gives the same grads bit for bit
    for a, b in zip(trees.leaves(tg), trees.leaves(tt.accum_grad_fn(tt.state.params, tb))):
        assert a is None or torch.equal(a, b)


GRAD_EPOCHS = [("sum", 0, False), ("sum", 2, True), ("ema", 0, True), ("ema", 2, False)]


@pytest.mark.parametrize("emb_trainable", [False, True])
@pytest.mark.parametrize("accumulate,cap,ragged", GRAD_EPOCHS)
def test_grad_epoch_on_flat_matches_jax(tmp_path, accumulate, cap, ragged, emb_trainable):
    """One accumulate epoch over each domain of a long-tailed block (4, 3 and
    2 batches; the block pads to 4, so a short domain's tail is all-pad
    batches: gated out, or not run with real step counts), shuffle off,
    onto a non-zero accumulator; the meta mask leaves the domain table out
    (meta_parms all_hidden), so that leaf stays None."""
    jt, tt = trainer_pair(tmp_path, "mlp_meta_maml", emb_trainable, dropout=0.5,
                          meta_parms=["all_hidden"])
    js, ts = JMAML(jt), MAMLStrategy(tt)
    jblock, n_steps = jt.train_block()
    tblock, _ = tt.train_block()
    steps = tt.steps_per_domain()
    assert steps == [4, 3, 2]
    rng = np.random.default_rng(4)
    start = jax.tree_util.tree_map(
        lambda x: rng.normal(0, 1e-3, x.shape).astype(np.float32),
        jax.device_get(jt.state.params))
    jacc = jax.tree_util.tree_map(jnp.asarray, start)
    tacc = trees.tree_map(lambda m, x: x if m else None, ts.mask, params_from_jax(start))
    for dom in (2, 0, 1):
        real = steps[dom] if ragged else None
        jacc = jfused._grad_epoch_on_flat(
            jt.accum_grad_fn, jt.state.params, jt.state.batch_stats,
            {k: v[dom] for k, v in jblock.items()}, jax.random.PRNGKey(dom), n_steps,
            jt.dataset.batch_size, jacc, accumulate, cap, shuffle=False, real_steps=real)
        tacc = fused._grad_epoch_on_flat(
            tt.accum_grad_fn, tt.state.params, {k: v[dom] for k, v in tblock.items()},
            tt.gen, n_steps, tt.dataset.batch_size, tacc, ts.mask, accumulate, cap,
            shuffle=False, real_steps=real)
    _grads_close(tacc, jacc, ts.mask)
    assert tacc["model"]["embedding"]["domain_emb"] is None
    assert all(x is None for n, x in trees.leaves_with_names(tacc) if "emb" in n)
    with pytest.raises(ValueError, match="unknown accumulate"):
        fused._grad_epoch_on_flat(tt.accum_grad_fn, tt.state.params,
                                  {k: v[0] for k, v in tblock.items()}, tt.gen, n_steps,
                                  tt.dataset.batch_size, tacc, ts.mask, "other")


def test_accumulate_split_matches_jax(tmp_path):
    """MAML's accumulate_split: the split's order drawn from np_rng (the same
    draw as the JAX package's stack_batches), capped at meta_train_step."""
    jt, tt = trainer_pair(tmp_path, "mlp_meta_maml", False, meta_train_step=2)
    js, ts = JMAML(jt), MAMLStrategy(tt)
    split_j, split_t = jt.dataset.train[0], tt.dataset.train[0]
    jacc = js.accumulate_split(jt.state.params, jt.state.batch_stats, split_j,
                               jax.tree_util.tree_map(jnp.zeros_like, jt.state.params))
    tacc = ts.accumulate_split(tt.state.params, split_t, fused.zeros_acc(ts.mask, tt.state.params))
    _grads_close(tacc, jacc, ts.mask)
    assert tt.np_rng.bit_generator.state == jt.np_rng.bit_generator.state


@pytest.mark.parametrize("target", [-1, 2])
def test_support_query_and_cap_steps_match_jax(tmp_path, target):
    """MetaStrategy.support_query (the split drawn from np_rng; a target
    domain redirects the query to its train split) and cap_steps."""
    jt, tt = trainer_pair(tmp_path, "mlp_meta_maml", False, meta_split="meta-train/val",
                          meta_split_ratio=0.3, meta_train_step=2, target_domain=target)
    js, ts = JMAML(jt), MAMLStrategy(tt)
    for idx in (0, 1):
        for a, b in zip(ts.support_query(idx), js.support_query(idx)):
            assert np.array_equal(a.uid, b.uid) and np.array_equal(a.label, b.label)
    assert tt.np_rng.bit_generator.state == jt.np_rng.bit_generator.state
    assert [ts.cap_steps(n) for n in (1, 2, 5)] == [js.cap_steps(n) for n in (1, 2, 5)] == [1, 2, 2]


def _uncertainty_pair(tmp_path, emb_trainable, long_tail=True):
    jt, tt = trainer_pair(tmp_path, "mlp_uncertainty_weight", emb_trainable,
                          long_tail=long_tail)
    log_vars = np.asarray([[0.6], [1.3], [0.9]], np.float32)
    jt.state = jt.state.replace(params={**jt.state.params,
                                        "uncertainty": {"log_vars": jnp.asarray(log_vars)}})
    tt.state = tt.state.replace(params=params_from_jax(jax.device_get(jt.state.params)))
    return jt, tt


@pytest.mark.parametrize("emb_trainable", [False, True])
def test_uncertainty_loss_and_grads_match_jax(tmp_path, emb_trainable):
    jt, tt = _uncertainty_pair(tmp_path, emb_trainable)
    assert jt.step_cfg.uncertainty_weight and tt.step_cfg.uncertainty_weight
    assert sorted(tt.state.params) == ["model", "uncertainty"]
    for dom in (0, 2):
        jb, tb = _first_batch(jt, tt, dom, cut=25)
        (jloss, (_, _, jdata)), jg = jax.value_and_grad(jt.loss_fn, has_aux=True)(
            jt.state.params, jt.state.batch_stats, jb, jax.random.PRNGKey(0), False)
        tdata, tg = make_loss_grad(tt.model, tt.step_cfg)(tt.state.params, tb, None,
                                                          train=False)
        np.testing.assert_allclose(float(tdata), float(jdata), rtol=2e-6)
        tloss, tdata2 = tt.loss_fn(tt.state.params, tb)
        np.testing.assert_allclose([float(tloss), float(tdata2)], [float(jloss), float(jdata)],
                                   rtol=2e-6)
        _grads_close(tg, jg)
        lv = tg["uncertainty"]["log_vars"].numpy()[:, 0]
        assert lv[dom] != 0.0 and np.all(np.delete(lv, dom) == 0.0)
        # the accumulate step takes the same route
        _grads_close(tt.accum_grad_fn(tt.state.params, tb), jg)


def test_loss_grad_gate():
    """The plain MLP takes the fused kernel path; the uncertainty-weighted
    loss autograd; the autograd path also takes lane-stacked batches: [L]
    data losses, each lane's the one-tower loss of its own params."""
    from mamdr_tpu_torch.models.deepctr import MLP

    model = MLP(10, 10, 3, 4, 4, 4, (8,), generator=torch.Generator().manual_seed(0))
    fast = make_loss_grad(model, StepConfig())
    auto = make_loss_grad(model, StepConfig(uncertainty_weight=True))
    assert fast.__qualname__ == make_fast_loss_grad(model, StepConfig()).__qualname__
    assert auto.__qualname__ == make_autograd_loss_grad(model, StepConfig()).__qualname__
    g = torch.Generator().manual_seed(1)
    lanes = {"uid": torch.randint(0, 10, (2, 4), generator=g, dtype=torch.int32),
             "pid": torch.randint(0, 10, (2, 4), generator=g, dtype=torch.int32),
             "domain": torch.tensor([[0] * 4, [2] * 4], dtype=torch.int32),
             "label": torch.randint(0, 2, (2, 4), generator=g).float(),
             "weight": torch.ones((2, 4))}
    one = {"model": model.param_tree(),
           "uncertainty": {"log_vars": torch.tensor([[1.0], [1.5], [0.7]])}}
    params = trees.tree_map(lambda x: torch.stack([x, x * 1.1]), one)
    data, grads = auto(params, lanes, None, train=False)
    assert data.shape == (2,)
    for lane in range(2):
        p = trees.tree_map(lambda x: x[lane], params)
        b = {k: v[lane] for k, v in lanes.items()}
        d1, g1 = auto(p, b, None, train=False)
        torch.testing.assert_close(data[lane], d1, rtol=2e-6, atol=0)
        for a, b_ in zip(trees.leaves(grads), trees.leaves(g1)):
            torch.testing.assert_close(a[lane], b_, rtol=2e-5, atol=1e-7)


@pytest.mark.parametrize("long_tail", [False, True])
def test_uncertainty_eval_matches_jax(tmp_path, long_tail):
    """Per-domain val and test loss of the uncertainty-weighted model (each
    lane's bce/var^2 + log(var) + l2) and AUC against the JAX package's."""
    jt, tt = _uncertainty_pair(tmp_path, False, long_tail)
    for mode in ("val", "test"):
        _, _, jl, ja = jt.val_and_test(mode)
        _, _, tl, ta = tt.val_and_test(mode)
        np.testing.assert_allclose([tl[k] for k in jl], [jl[k] for k in jl], rtol=2e-5)
        np.testing.assert_allclose([ta[k] for k in ja], [ja[k] for k in ja], atol=1e-6)
