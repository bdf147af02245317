"""Flat Adam and the train step of the port vs the JAX package.

- flat Adam vs ``flat_adam`` over several updates on the same gradients:
  the flat ``mu``/``nu`` vectors pack the same leaves in the same order.
  Tolerance rtol 1e-6: the bias correction ``b ** count`` is a float32
  ``pow`` in both frameworks and may differ by an ulp.
- a few train steps (dropout off) vs ``make_train_step``, which on the CPU
  takes the JAX package's autodiff path, from the same params; the all-pad
  gate leaves params, slots and ``step`` exactly as they were. Tolerance
  rtol 2e-5 for gradients summed in another order, passed through Adam's
  normalisation, with absolute floors for elements that cancel to near zero:
  the slots 2e-5 of their largest value, and params 1e-5 = lr/1000 — Adam
  divides by sqrt(nu), so a table row whose gradient is almost only its l2
  term still takes a step of order lr, steered by the last bits. A float64
  evaluation of the same steps (``test_adam_slots_within_float32_rounding``)
  shows both packages within rounding of it.
- the subset lane step (``make_subset_train_step``: lane-stacked trainable
  state, frozen tables shared) vs the JAX ``make_subset_train_step`` under
  ``jax.vmap`` over 3 lanes, each with its own weights and batches; the
  per-lane all-pad gate leaves that lane's params, slots and step exactly as
  they were while the other lanes move. Same tolerances.
- the table rule (``models/embeddings``: tables, frozen tables) on the trees
  of bases whose tables differ (the MLP, WDL's dim-1 tables, PLE, STAR's
  top-level ones), with and without ``emb_trainable``, vs what the JAX
  package does on the same tree, and the port's optimizer mask and l2 term
  vs the rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamdr_tpu.config import ExperimentConfig as JConfig
from mamdr_tpu.models.zoo import build_model as jax_build_model
from mamdr_tpu.train.flat_optimizer import flat_adam as jax_flat_adam
from mamdr_tpu.train.state import TrainState as JState
from mamdr_tpu.train.steps import StepConfig as JStepConfig
from mamdr_tpu.train.steps import _l2_term as jax_l2_term
from mamdr_tpu.train.steps import make_optimizer as jax_make_optimizer
from mamdr_tpu.train.steps import make_subset_train_step as jax_make_subset_train_step
from mamdr_tpu.train.steps import make_train_step as jax_make_train_step
from mamdr_tpu.utils import trees as jtrees
from mamdr_tpu_torch.config import ExperimentConfig
from mamdr_tpu_torch.convert import params_from_jax
from mamdr_tpu_torch.models.embeddings import frozen_mask, table_mask
from mamdr_tpu_torch.models.zoo import build_model
from mamdr_tpu_torch.train.flat_optimizer import FlatAdam, apply_updates
from mamdr_tpu_torch.train.state import TrainState
from mamdr_tpu_torch.train.steps import (
    StepConfig,
    make_optimizer,
    make_subset_train_step,
    make_autograd_loss_grad,
    make_l2_term,
    make_train_step,
)
from mamdr_tpu_torch.utils import trees


def _tree(rng):
    return {
        "b": {"kernel": rng.normal(0, 1, (3, 4)).astype(np.float32),
              "bias": rng.normal(0, 1, 4).astype(np.float32)},
        "a": {"user_emb": rng.normal(0, 1, (5, 2)).astype(np.float32)},
        "c": rng.normal(0, 1, 6).astype(np.float32),
    }


def test_flat_adam_matches_jax():
    rng = np.random.default_rng(0)
    params = _tree(rng)
    mask = {"b": {"kernel": True, "bias": True}, "a": {"user_emb": False}, "c": True}
    jtx, ttx = jax_flat_adam(1e-2, mask), FlatAdam(1e-2, mask)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, params), params_from_jax(params)
    js, ts = jtx.init(jp), ttx.init(tp)
    for _ in range(5):
        g = _tree(rng)
        ju, js = jtx.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, ju)
        tg = params_from_jax(g)
        tg["a"]["user_emb"] = None  # frozen: the port passes no gradient
        tu, ts = ttx.update(tg, ts)
        assert tu["a"]["user_emb"] is None
        tp = apply_updates(tp, tu)
    assert int(ts.count) == int(js.count) == 5
    np.testing.assert_allclose(ts.mu.numpy(), np.asarray(js.mu), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(ts.nu.numpy(), np.asarray(js.nu), rtol=1e-6, atol=1e-9)
    jnamed = dict(zip(trees.param_names(jax.device_get(jp)), jax.tree_util.tree_leaves(jp)))
    for name, leaf in trees.leaves_with_names(tp):
        np.testing.assert_allclose(leaf.numpy(), np.asarray(jnamed[name]),
                                   rtol=1e-6, atol=1e-8, err_msg=name)


def _batch(rng, n_uid, n_pid, batch, domain, all_pad=False):
    w = (rng.uniform(0, 1, batch) > 0.2).astype(np.float32)
    return {
        "uid": rng.integers(0, n_uid, batch).astype(np.int32),
        "pid": rng.integers(0, n_pid, batch).astype(np.int32),
        "domain": np.full(batch, domain, np.int32),
        "label": rng.integers(0, 2, batch).astype(np.float32),
        "weight": np.zeros_like(w) if all_pad else w,
    }


def _slots_close(t_flat, j_flat, what):
    """Adam slot vectors: rtol 2e-5 with an absolute floor of 2e-5 of the
    slot's largest value, as the port's gradient checks hold a gradient
    against the step's largest. An element summed over the batch with
    cancellation (a first-layer dW entry) keeps only the absolute rounding of
    its terms, which another row order already moves by ~1e-4 of its own
    leaf's max (``test_adam_slots_within_float32_rounding``)."""
    np.testing.assert_allclose(t_flat, j_flat, rtol=2e-5,
                               atol=2e-5 * float(np.abs(j_flat).max()), err_msg=what)


def _step_pair(emb_trainable):
    """The JAX and the port's train steps from one init, the port's
    optimizer and the four batches (the third all-pad)."""
    d = {
        "model": {"name": "mlp", "user_dim": 8, "item_dim": 8, "domain_dim": 8,
                  "hidden_dim": [32, 16], "dropout": 0.0},
        "train": {"emb_trainable": emb_trainable, "learning_rate": 1e-2},
        "dataset": {"name": "synthetic"},
    }
    n_uid, n_pid, n_dom, batch = 50, 60, 3, 32
    rng = np.random.default_rng(0)
    batches = [_batch(rng, n_uid, n_pid, batch, 1), _batch(rng, n_uid, n_pid, batch, 2),
               _batch(rng, n_uid, n_pid, batch, 0, all_pad=True),
               _batch(rng, n_uid, n_pid, batch, 1)]

    jmodel = jax_build_model(JConfig.from_dict(d), n_uid, n_pid, n_dom)
    jb0 = {k: jnp.asarray(v) for k, v in batches[0].items()}
    jparams = {"model": jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
        jb0["uid"], jb0["pid"], jb0["domain"], train=False)["params"]}
    jtx = jax_make_optimizer("adam", 1e-2, jparams, emb_trainable, flat=True)
    jstep, _ = jax_make_train_step(
        jmodel, jtx, JStepConfig(l2_emb=1e-5, emb_trainable=emb_trainable))
    jstep = jax.jit(jstep)
    js = JState.create(jparams, jtx.init(jparams), {}, jax.random.PRNGKey(1))

    tmodel = build_model(ExperimentConfig.from_dict(d), n_uid, n_pid, n_dom)
    tparams = params_from_jax(jax.device_get(jparams))
    ttx = make_optimizer("adam", 1e-2, tparams, emb_trainable, flat=True)
    tstep = make_train_step(tmodel, ttx, StepConfig(1e-5, emb_trainable))
    ts = TrainState.create(tparams, ttx.init(tparams), seed=0, device="cpu")
    return batches, (jstep, js), (tmodel, ttx, tstep, ts)


@pytest.mark.parametrize("emb_trainable", [False, True])
def test_train_steps_match_jax_and_all_pad_gate(emb_trainable):
    batches, (jstep, js), (_, ttx, tstep, ts) = _step_pair(emb_trainable)
    for i, b in enumerate(batches):
        js, jl = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        before = ts
        ts, tl = tstep(ts, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(tl), float(jl), rtol=2e-5, atol=1e-7)
        if i == 2:  # all-pad: an exact no-op
            assert int(ts.step) == int(before.step)
            for a, b_ in zip(trees.leaves(ts.params), trees.leaves(before.params)):
                assert torch.equal(a, b_)
            for a, b_ in zip(ts.opt_state, before.opt_state):
                assert torch.equal(a, b_)
    assert int(ts.step) == int(js.step) == 3
    assert int(ts.opt_state.count) == int(js.opt_state.count) == 3
    _slots_close(ts.opt_state.mu.numpy(), np.asarray(js.opt_state.mu), "mu")
    _slots_close(ts.opt_state.nu.numpy(), np.asarray(js.opt_state.nu), "nu")
    jnamed = dict(zip(trees.param_names(jax.device_get(js.params)),
                      jax.tree_util.tree_leaves(js.params)))
    for name, leaf in trees.leaves_with_names(ts.params):
        np.testing.assert_allclose(leaf.numpy(), np.asarray(jnamed[name]),
                                   rtol=2e-5, atol=1e-5, err_msg=name)


def test_adam_slots_within_float32_rounding():
    """The parity bounds are rounding, not a fault: the same three steps
    evaluated in float64 (autograd through the port's forward, Adam in
    float64) against the port's and the JAX package's float32 runs, and
    against the port's runs with each batch's rows permuted (the same
    function, its batch sums taken in other orders). The port's and JAX's
    slots stay within the slots' bound of the float64 ones; the port lies no
    farther from float64, in the slots and in each parameter leaf, than
    twice what another row order moves it, and JAX no farther than the
    params' bound. Prints the worst elements (-s)."""
    batches, (jstep, js), (tmodel, _, tstep, ts0) = _step_pair(True)
    ts = ts0
    for b in batches:
        js, _ = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, _ = tstep(ts, {k: torch.from_numpy(v) for k, v in b.items()})
    loss_grad = make_autograd_loss_grad(tmodel, StepConfig(1e-5, True))
    p64 = trees.tree_map(lambda x: x.double(), ts0.params)
    mu = nu = None
    count = 0
    for b in batches:
        if b["weight"].sum() == 0:
            continue
        count += 1
        b64 = {k: torch.from_numpy(v).double() if v.dtype == np.float32 else
               torch.from_numpy(v) for k, v in b.items()}
        g = torch.cat([x.reshape(-1) for x in trees.leaves(loss_grad(p64, b64, None,
                                                                      train=False)[1])])
        mu = 0.1 * g if mu is None else 0.9 * mu + 0.1 * g
        nu = 1e-3 * g * g if nu is None else 0.999 * nu + 1e-3 * g * g
        step = iter(torch.split(-1e-2 * (mu / (1 - 0.9 ** count))
                                / (torch.sqrt(nu / (1 - 0.999 ** count)) + 1e-8),
                                [x.numel() for x in trees.leaves(p64)]))
        p64 = trees.tree_map(lambda x: x + next(step).reshape(x.shape), p64)
    perm_rng = np.random.default_rng(1)
    runs = []
    for _ in range(12):
        tp = ts0
        for b in batches:
            perm = perm_rng.permutation(b["weight"].shape[0])
            tp, _ = tstep(tp, {k: torch.from_numpy(np.ascontiguousarray(v[perm]))
                               for k, v in b.items()})
        runs.append(tp)

    def spread(get, ref):
        return max(float(np.abs(get(r) - ref).max()) for r in runs)

    f64, port = mu.numpy(), ts.opt_state.mu.double().numpy()
    jx = np.asarray(js.opt_state.mu).astype(np.float64)
    worst = int(np.argmax(np.abs(port - jx)))
    mu_spread = spread(lambda r: r.opt_state.mu.double().numpy(), f64)
    print(f"mu[{worst}]: port {port[worst]:.6e} JAX {jx[worst]:.6e} float64 "
          f"{f64[worst]:.6e}; |port-f64| {abs(port[worst] - f64[worst]):.3e} |JAX-f64| "
          f"{abs(jx[worst] - f64[worst]):.3e}; over all mu: |port-f64| "
          f"{np.abs(port - f64).max():.3e} |JAX-f64| {np.abs(jx - f64).max():.3e} "
          f"row-order {mu_spread:.3e}")
    _slots_close(port, f64, "port mu vs float64")
    _slots_close(jx, f64, "JAX mu vs float64")
    _slots_close(ts.opt_state.nu.double().numpy(), nu.numpy(), "port nu vs float64")
    assert np.abs(port - f64).max() <= 2 * mu_spread
    jnamed = dict(zip(trees.param_names(jax.device_get(js.params)),
                      jax.tree_util.tree_leaves(js.params)))
    f64p = dict(trees.leaves_with_names(p64))
    for name, leaf in trees.leaves_with_names(ts.params):
        ref = f64p[name].numpy()
        t, j = leaf.double().numpy(), np.asarray(jnamed[name]).astype(np.float64)
        s = spread(lambda r: dict(trees.leaves_with_names(r.params))[name].double().numpy(),
                   ref)
        print(f"{name}: |port-JAX| {np.abs(t - j).max():.3e} |port-f64| "
              f"{np.abs(t - ref).max():.3e} |JAX-f64| {np.abs(j - ref).max():.3e} "
              f"row-order {s:.3e}")
        assert np.abs(t - ref).max() <= 2 * s + 1e-12, name
        assert np.abs(j - ref).max() <= 1e-5, name


@pytest.mark.parametrize("emb_trainable", [False, True])
def test_subset_lane_step_matches_jax_vmap(emb_trainable):
    d = {
        "model": {"name": "mlp", "user_dim": 8, "item_dim": 8, "domain_dim": 8,
                  "hidden_dim": [32, 16], "dropout": 0.0},
        "train": {"emb_trainable": emb_trainable, "learning_rate": 1e-2},
        "dataset": {"name": "synthetic"},
    }
    n_uid, n_pid, n_dom, batch, lanes = 50, 60, 3, 32, 3
    rng = np.random.default_rng(0)
    # steps x lanes batches; step 1 is all-pad in lane 1 only; one batch holds
    # out-of-range domain ids, which clip per lane
    steps = [[_batch(rng, n_uid, n_pid, batch, l, all_pad=(s == 1 and l == 1))
              for l in range(lanes)] for s in range(3)]
    steps[2][0]["domain"][:4] = [-3, 7, n_dom, 2**31 - 1]
    stacked = [{k: np.stack([b[k] for b in row]) for k in row[0]} for row in steps]

    jmodel = jax_build_model(JConfig.from_dict(d), n_uid, n_pid, n_dom)
    jb0 = {k: jnp.asarray(v) for k, v in steps[0][0].items()}
    jparams = {"model": jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
        jb0["uid"], jb0["pid"], jb0["domain"], train=False)["params"]}
    frozen = jtrees.named_tree_map(
        lambda n, x: (not emb_trainable) and ("user_emb" in n or "item_emb" in n), jparams)
    jtx = jax_make_optimizer("adam", 1e-2, jparams, emb_trainable, flat=True)
    jstep, jto_sub, jcombine = jax_make_subset_train_step(
        jmodel, jtx, JStepConfig(l2_emb=1e-5, emb_trainable=emb_trainable), frozen, jparams)
    # lane l's trainable weights: the initial ones scaled by (1 + l/10)
    lane_scale = np.asarray([1.0, 1.1, 1.2], np.float32)
    jsub = jax.tree_util.tree_map(
        lambda f, x: jnp.zeros((lanes,), x.dtype) if f
        else x[None] * lane_scale.reshape(-1, *([1] * x.ndim)), frozen, jparams)
    jopt = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (lanes,) + x.shape),
                                  jtx.init(jparams))
    js = JState(params=jsub, opt_state=jopt, batch_stats={},
                rng=jax.random.split(jax.random.PRNGKey(1), lanes),
                step=jnp.zeros((lanes,), jnp.int32))
    jvstep = jax.jit(jax.vmap(jstep))

    tmodel = build_model(ExperimentConfig.from_dict(d), n_uid, n_pid, n_dom)
    tfull = params_from_jax(jax.device_get(jparams))
    tfrozen = trees.tree_map(bool, jax.device_get(frozen))
    ttx = make_optimizer("adam", 1e-2, tfull, emb_trainable, flat=True)
    tstep, to_sub, combine = make_subset_train_step(
        tmodel, ttx, StepConfig(1e-5, emb_trainable), tfrozen, tfull)
    tsub = trees.tree_map(
        lambda f, x: x if f else x[None] * torch.from_numpy(lane_scale).reshape(
            -1, *([1] * x.dim())), tfrozen, to_sub(tfull))
    opt0 = ttx.init(tfull)
    ts = TrainState(params=tsub, seed=torch.arange(lanes),
                    opt_state=type(opt0)(*(x.expand(lanes, *x.shape) for x in opt0)),
                    step=torch.zeros((lanes,), dtype=torch.int32))
    if not emb_trainable:  # placeholders in, the one shared table out
        assert tsub["model"]["embedding"]["user_emb"].dim() == 0
        assert (combine(tsub)["model"]["embedding"]["user_emb"]
                is tfull["model"]["embedding"]["user_emb"])

    for i, b in enumerate(stacked):
        js, jl = jvstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        before = ts
        ts, tl = tstep(ts, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-5, atol=1e-7)
        if i == 1:  # lane 1 saw an all-pad batch: an exact no-op there only
            assert ts.step.tolist() == [2, 1, 2]
            for a, b_ in zip(trees.leaves(ts.params), trees.leaves(before.params)):
                if a.dim() > 0:
                    assert torch.equal(a[1], b_[1]) and not torch.equal(a[0], b_[0])
            for a, b_ in zip(ts.opt_state, before.opt_state):
                assert torch.equal(a[1], b_[1]) and not torch.equal(a[2], b_[2])
    assert ts.step.tolist() == np.asarray(js.step).tolist() == [3, 2, 3]
    assert ts.opt_state.count.tolist() == np.asarray(js.opt_state.count).tolist()
    np.testing.assert_allclose(ts.opt_state.mu.numpy(), np.asarray(js.opt_state.mu),
                               rtol=2e-5, atol=1e-8)
    np.testing.assert_allclose(ts.opt_state.nu.numpy(), np.asarray(js.opt_state.nu),
                               rtol=2e-5, atol=1e-12)
    jnamed = dict(zip(trees.param_names(jax.device_get(js.params)),
                      jax.tree_util.tree_leaves(js.params)))
    for name, leaf in trees.leaves_with_names(ts.params):
        if leaf.dim() > 0:
            np.testing.assert_allclose(leaf.numpy(), np.asarray(jnamed[name]),
                                       rtol=2e-5, atol=1e-5, err_msg=name)


RULE_BASES = {
    "mlp": {},
    "wdl": {},
    "ple": {"tower_hidden_dim": [8], "num_experts": 3, "gate_dnn_hidden_units": [8],
            "specific_expert_num": 2, "shared_expert_num": 1, "num_levels": 1},
    "star": {"norm": "pn", "dense": "star", "auxiliary_net": True, "auxiliary_dim": 8},
}


def _leaf_names(tree, keep):
    """The '/'-joined names of the leaves of a JAX tree where ``keep(leaf)``."""
    return {n for n, x in zip(trees.param_names(jax.device_get(tree)),
                              jax.tree_util.tree_leaves(tree)) if keep(np.asarray(x))}


@pytest.mark.parametrize("emb_trainable", [False, True])
@pytest.mark.parametrize("base", list(RULE_BASES))
def test_table_rule_matches_jax(base, emb_trainable):
    """The frozen mask is the set of leaves to which the JAX package's
    ``make_optimizer`` gives a zero update on all-ones gradients; the tables
    less the frozen ones are the leaves its ``_l2_term`` reaches (a frozen
    table's term is a constant). The port's optimizer trains exactly the
    leaves the rule leaves unfrozen, and its l2 term reaches the same leaves
    as the JAX package's."""
    d = {"model": {"name": base, "user_dim": 8, "item_dim": 8, "domain_dim": 8,
                   "hidden_dim": [16, 8], "dropout": 0.0, **RULE_BASES[base]},
         "train": {}, "dataset": {"name": "synthetic"}}
    tmodel = build_model(ExperimentConfig.from_dict(d), 20, 30, 3,
                         generator=torch.Generator().manual_seed(0))
    jmodel = jax_build_model(JConfig.from_dict(d), 20, 30, 3)
    z = jnp.zeros(2, jnp.int32)
    jparams = {"model": jmodel.init({"params": jax.random.PRNGKey(0),
                                     "dropout": jax.random.PRNGKey(0)}, z, z, z)["params"]}
    jtx = jax_make_optimizer("sgd", 1.0, jparams, emb_trainable)
    updates, _ = jtx.update(jax.tree_util.tree_map(jnp.ones_like, jparams), jtx.init(jparams),
                            jparams)
    jfrozen = _leaf_names(updates, lambda u: not u.any())
    reach = jax.grad(lambda p: jax_l2_term(p, 1.0, emb_trainable))(jparams)
    jl2 = _leaf_names(reach, lambda g: g.any())

    tparams = {"model": tmodel.param_tree()}
    frozen = {n for n, f in trees.leaves_with_names(frozen_mask(tparams, emb_trainable)) if f}
    tables = {n for n, t in trees.leaves_with_names(table_mask(tparams)) if t}
    assert frozen == jfrozen and bool(frozen) != emb_trainable
    assert tables - frozen == jl2 and frozen <= tables
    if base == "wdl":
        assert {"model/linear/linear_user_emb", "model/linear/linear_domain_emb"} <= tables
    if base == "star":
        assert "model/user_emb" in tables

    tx = make_optimizer("adam", 1e-3, tparams, emb_trainable)
    assert {n for n, m in trees.leaves_with_names(tx.mask) if not m} == frozen
    live = trees.tree_map(lambda x: x.detach().requires_grad_(True), tparams["model"])
    term = make_l2_term(tmodel, StepConfig(1.0, emb_trainable))(live)
    grads = torch.autograd.grad(term, trees.leaves(live), allow_unused=True)
    assert {"model/" + n for n, g in zip(trees.param_names(live), grads)
            if g is not None and bool(g.any())} == jl2
