"""The fused tower step of the port vs the JAX package's Pallas kernel.

CPU: ``tower_grad_reference`` (the plain version K1 is held to) against
``_fused_tower_grad(..., interpret=True)`` on the same inputs and seeds, and
the port's ``make_fast_loss_grad`` against ``maybe_make_fast_loss_grad``
(interpret mode) on converted params. Tolerance rtol 2e-5 (the JAX
package's own CPU bound for this kernel, tests/test_fused_mlp_step.py):
both run float32 matmuls, summed in different orders.

The lane-batched plain version (``tower_grad_reference_lanes``, what K1 with a
lane axis is held to): lane l bit-equal to the single-lane plain version and
within the same tolerance of the Pallas kernel run per lane, with a partial
and an all-pad lane in one call; two lanes at the same step get different
dropout masks (``lane_seeds``).

Kernel K1's arithmetic and launch plan in plain Python: ``tf32_split`` (the
kernel's operand splitting) gives float32-accurate products from three TF32
terms where one TF32 term does not, which is why the card tolerance can stay
where it was; ``k1_launch_plan`` fits a block's shared memory and at most 4
launches at the shapes the card tests run, and raises for a tower too wide.

Kernel K1 against the plain version on the card: test_torch_kernels_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamdr_tpu.config import ExperimentConfig as JConfig
from mamdr_tpu.models.zoo import build_model as jax_build_model
from mamdr_tpu.ops.fast_random import key_to_seed
from mamdr_tpu.ops.fused_mlp_step import _fused_tower_grad, maybe_make_fast_loss_grad
from mamdr_tpu.train.steps import StepConfig as JStepConfig
from mamdr_tpu_torch.config import ExperimentConfig
from mamdr_tpu_torch.convert import params_from_jax
from mamdr_tpu_torch.models.zoo import build_model
from mamdr_tpu_torch.ops.fast_random import dropout_mask, lane_seeds, step_seeds
from mamdr_tpu_torch.ops.fused_mlp_step import (
    SHARED_BYTES_MAX,
    fused_tower_grad_lanes,
    k1_launch_plan,
    make_fast_loss_grad,
    tf32_split,
    tower_forward_reference,
    tower_grad_reference,
)
from mamdr_tpu_torch.train.steps import StepConfig
from mamdr_tpu_torch.utils.kernel_check import relu_flip_rows
from mamdr_tpu_torch.utils import trees

RTOL, ATOL = 2e-5, 1e-7


def tower_inputs(dims, batch, seed=0, all_pad=False, partial=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (batch, dims[0])).astype(np.float32)
    label = rng.integers(0, 2, batch).astype(np.float32)
    weight = (rng.uniform(0, 1, batch) > 0.2).astype(np.float32)
    if all_pad:
        weight[:] = 0.0
    if partial:
        weight[: batch // 3] = 1.0
        weight[batch // 3 :] = 0.0
    dense = []
    for i in range(len(dims) - 1):
        lim = np.sqrt(6.0 / (dims[i] + dims[i + 1]))
        dense.append(rng.uniform(-lim, lim, (dims[i], dims[i + 1])).astype(np.float32))
        dense.append(rng.normal(0, 0.1, dims[i + 1]).astype(np.float32))
    dense.append(rng.normal(0, 0.3, (dims[-1], 1)).astype(np.float32))
    seeds = np.array([0xDEADBEEF, 7, 2**31 + 5][: len(dims) - 1], np.uint32)
    return x, label, weight, seeds, dense


def run_jax_tower(x, label, weight, seeds, dense, dims, rate):
    n = len(dims) - 1
    jd = tuple(
        jnp.asarray(a[None, :] if (i < 2 * n and i % 2 == 1) else a)
        for i, a in enumerate(dense)
    )
    loss, dx, grads = _fused_tower_grad(
        jnp.asarray(x), jnp.asarray(label[:, None]), jnp.asarray(weight[:, None]),
        jnp.asarray(seeds), jd, tuple(dims), rate, interpret=True,
    )
    return float(loss), np.asarray(dx), [np.asarray(g) for g in grads]


def run_port_tower(fn, x, label, weight, seeds, dense, dims, rate, device="cpu"):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    loss, dx, grads = fn(
        t(x), t(label), t(weight), torch.from_numpy(seeds.astype(np.int64)).to(device),
        tuple(t(a) for a in dense), tuple(dims), rate,
    )
    return loss.item(), dx.cpu().numpy(), [g.cpu().numpy() for g in grads]


@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("case", ["mixed", "all_pad"])
def test_reference_matches_pallas_kernel(rate, case):
    dims = (24, 32, 16)
    args = tower_inputs(dims, 32, all_pad=case == "all_pad")
    lj, dxj, gj = run_jax_tower(*args, dims, rate)
    lt, dxt, gt = run_port_tower(tower_grad_reference, *args, dims, rate)
    np.testing.assert_allclose(lt, lj, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(dxt, dxj, rtol=RTOL, atol=ATOL)
    assert len(gt) == len(gj)
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a, b.reshape(a.shape), rtol=RTOL, atol=ATOL)
    if case == "all_pad":
        assert lt == 0.0 and not np.any(dxt) and not any(np.any(g) for g in gt)


def _cfgs(dropout, emb_trainable):
    d = {
        "model": {"name": "mlp", "user_dim": 8, "item_dim": 8, "domain_dim": 8,
                  "hidden_dim": [32, 16], "dropout": dropout},
        "train": {"emb_trainable": emb_trainable},
        "dataset": {"name": "synthetic"},
    }
    return JConfig.from_dict(d), ExperimentConfig.from_dict(d)


@pytest.mark.parametrize("emb_trainable", [True, False])
@pytest.mark.parametrize("dropout", [0.0, 0.5])
def test_fast_loss_grad_matches_jax(emb_trainable, dropout):
    jcfg, tcfg = _cfgs(dropout, emb_trainable)
    n_uid, n_pid, n_dom, batch = 50, 60, 3, 32
    jmodel = jax_build_model(jcfg, n_uid=n_uid, n_pid=n_pid, n_domain=n_dom)
    rng = np.random.default_rng(0)
    b_np = {
        "uid": rng.integers(0, n_uid, batch).astype(np.int32),
        "pid": rng.integers(0, n_pid, batch).astype(np.int32),
        "domain": np.full(batch, 1, np.int32),
        "label": rng.integers(0, 2, batch).astype(np.float32),
        "weight": (rng.uniform(0, 1, batch) > 0.2).astype(np.float32),
    }
    jb = {k: jnp.asarray(v) for k, v in b_np.items()}
    variables = jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jb["uid"], jb["pid"], jb["domain"], train=False,
    )
    jparams = {"model": variables["params"]}
    jcfg_step = JStepConfig(l2_emb=1e-5, emb_trainable=emb_trainable,
                            has_dropout=dropout > 0.0)
    jfast = maybe_make_fast_loss_grad(jmodel, jcfg_step, interpret=True)
    rng_key = jax.random.PRNGKey(3)
    jloss, jgrads = jfast(jparams, jb, rng_key, train=True)
    # the seeds the JAX wrapper derives, injected into the port
    seeds = np.array([int(key_to_seed(jax.random.fold_in(rng_key, i))) for i in range(2)],
                     np.int64)

    tmodel = build_model(tcfg, n_uid, n_pid, n_dom)
    tfast = make_fast_loss_grad(tmodel, StepConfig(1e-5, emb_trainable))
    tparams = params_from_jax(jax.device_get(jparams))
    tb = {k: torch.from_numpy(v) for k, v in b_np.items()}
    tloss, tgrads = tfast(tparams, tb, torch.from_numpy(seeds), train=True)

    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=RTOL, atol=ATOL)
    jnamed = dict(
        zip(trees.param_names(jax.device_get(jgrads)),
            jax.tree_util.tree_leaves(jgrads))
    )
    checked = 0
    for name, g in trees.leaves_with_names(tgrads):
        if not emb_trainable and ("user_emb" in name or "item_emb" in name):
            assert g is None  # frozen: no table-sized gradient at all
            assert not np.any(np.asarray(jnamed[name]))
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(jnamed[name]),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
        checked += 1
    assert checked == (8 if emb_trainable else 6)


@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_lane_batched_reference(rate):
    """Lanes 0..3: mixed, partial, all-pad, mixed; each with its own weights,
    data and seeds. On CPU tensors fused_tower_grad_lanes is the plain
    lane-batched version."""
    dims = (24, 32, 16)
    per = [tower_inputs(dims, 32, seed=l, partial=l == 1, all_pad=l == 2) for l in range(4)]
    for l, p in enumerate(per):  # distinct seeds per lane
        p[3][:] = (p[3].astype(np.uint64) + 1000 * l).astype(np.uint32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    stack = lambda i: t(np.stack([p[i] for p in per]))
    dense = tuple(t(np.stack([p[4][i] for p in per])) for i in range(len(per[0][4])))
    seeds = t(np.stack([p[3] for p in per]).astype(np.int64))
    loss, dx, grads = fused_tower_grad_lanes(stack(0), stack(1), stack(2), seeds, dense,
                                             dims, rate)
    assert loss.shape == (4,) and dx.shape == (4, 32, 24)
    assert [g.shape for g in grads] == [d.shape for d in dense]
    for l, p in enumerate(per):
        l1, dx1, g1 = run_port_tower(tower_grad_reference, *p, dims, rate)
        assert loss[l].item() == l1  # bit-equal to the single-lane plain version
        np.testing.assert_array_equal(dx[l].numpy(), dx1)
        for a, b in zip(grads, g1):
            np.testing.assert_array_equal(a[l].numpy(), b)
        lj, dxj, gj = run_jax_tower(*p, dims, rate)  # the Pallas kernel, this lane
        np.testing.assert_allclose(loss[l].item(), lj, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(dx[l].numpy(), dxj, rtol=RTOL, atol=ATOL)
        for a, b in zip(grads, gj):
            np.testing.assert_allclose(a[l].numpy(), b.reshape(a[l].shape), rtol=RTOL,
                                       atol=ATOL)
    assert loss[2].item() == 0.0 and not dx[2].any() and not any(g[2].any() for g in grads)


def test_lanes_at_the_same_step_get_different_masks():
    base = lane_seeds(0xC0FFEE, 3, "cpu")
    assert len(set(base.tolist())) == 3 and int(base.max()) < 2**32 and int(base.min()) >= 0
    step = torch.full((3,), 7, dtype=torch.int32)
    seeds = step_seeds(base, step, n_layers=2)
    assert seeds.shape == (3, 2)
    for l in range(3):  # lane l's seeds are the single-lane seeds from its base
        assert torch.equal(seeds[l], step_seeds(int(base[l]), step[l], 2))
    masks = [dropout_mask(seeds[l, 0], 0.5, (32, 16)) for l in range(3)]
    assert not torch.equal(masks[0], masks[1]) and not torch.equal(masks[1], masks[2])
    # a lane's stream is not the un-laned stream of the same base seed
    assert not torch.equal(seeds[0], step_seeds(0xC0FFEE, step[0], 2))


def test_relu_edge_units_are_found_and_a_wrong_preactivation_refused():
    """relu_flip_rows: what a card check uses to hold kernel K1 to the
    independent plain version. Two evaluations whose z differ only by
    rounding at 0 give the rows of those units and their count; a sign
    difference away from 0 raises. With those rows' weights 0 the step's
    gradients do not depend on which way the units fall."""
    dims = (24, 16)
    x, label, weight, seeds, dense = tower_inputs(dims, 32)
    t = torch.from_numpy
    args = (t(x), t(seeds.astype(np.int64)), tuple(t(a) for a in dense), dims, 0.5)
    zs = tower_forward_reference(*args)[0]
    assert len(zs) == 1 and zs[0].shape == (32, 16)
    assert torch.equal(zs[0], t(x) @ t(dense[0]) + t(dense[1]))
    rows, count = relu_flip_rows(zs, zs)
    assert count == 0 and rows.shape == (32,) and not rows.any()
    other = zs[0].clone()
    scale = float(zs[0].abs().max())
    other[3, 5] = -1e-7 * scale if zs[0][3, 5] > 0 else 1e-7 * scale
    other[9, 0] = -1e-7 * scale if zs[0][9, 0] > 0 else 1e-7 * scale
    nudged = zs[0].clone()
    nudged[3, 5], nudged[9, 0] = -other[3, 5], -other[9, 0]
    rows, count = relu_flip_rows([nudged], [other])
    assert count == 2 and rows.nonzero().flatten().tolist() == [3, 9]
    lanes_rows, lanes_count = relu_flip_rows([torch.stack([nudged, zs[0]])],
                                             [torch.stack([other, zs[0]])])
    assert lanes_count == 2 and lanes_rows.shape == (2, 32) and not lanes_rows[1].any()
    with pytest.raises(ValueError, match="not within rounding"):
        relu_flip_rows(zs, [-zs[0]])
    # rows set aside carry no gradient: flip a unit of row 3 by hand
    w0 = torch.where(rows, 0.0, t(weight))
    run = lambda xx: tower_grad_reference(xx, t(label), w0, args[1], args[2], dims, 0.5)
    x2 = t(x).clone()
    x2[3] += 0.5  # moves row 3's units across 0; no other row changes
    (l1, dx1, g1), (l2, dx2, g2) = run(t(x)), run(x2)
    keep = ~rows
    assert torch.equal(dx1[keep], dx2[keep]) and not dx2[3].any()
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


def _bench_operands():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(0, 0.1, (1024, 384)).astype(np.float32))
    lim = np.sqrt(6.0 / (384 + 256))
    b = torch.from_numpy(rng.uniform(-lim, lim, (384, 256)).astype(np.float32))
    return a, b


def test_tf32_split_is_exact_and_tf32():
    """hi carries TF32's 11 significant bits (low 13 mantissa bits clear), lo
    too, and hi + lo gives x back within 2^-21 |x|."""
    a, _ = _bench_operands()
    x = torch.cat([a.flatten(), torch.tensor([0.0, -0.0, 1.0, -1.5, 3e-20, 1e20])])
    hi, lo = tf32_split(x)
    assert hi.dtype == lo.dtype == torch.float32 and hi.shape == x.shape
    for part in (hi, lo):
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    assert bool(((hi - x).abs() <= x.abs() * 2.0**-11).all())  # hi: x to 11 bits, to nearest
    assert bool(((hi.double() + lo.double() - x.double()).abs() <= x.abs().double() * 2.0**-21).all())
    hi2, lo2 = tf32_split(hi)  # a TF32 value splits into itself and 0
    assert torch.equal(hi2, hi) and not bool(lo2.any())


@pytest.mark.parametrize("terms,within", [(3, True), (1, False)])
def test_three_tf32_terms_are_float32_accurate_and_one_is_not(terms, within):
    """At the bench shapes (B 1024, 384 -> 256) the three-term product of
    split operands is within 2e-6 of the float64 product (relative to its
    largest entry), as a float32 product is; the single TF32 term is not (it
    is off by 1e-4 and more), so plain TF32 would not hold the card tests'
    1e-4 of each output's max and the compensation is what keeps it."""
    a, b = _bench_operands()
    (ah, al), (bh, bl) = tf32_split(a), tf32_split(b)
    want = a.double() @ b.double()
    got = ah @ bh if terms == 1 else (al @ bh + ah @ bl) + ah @ bh  # small terms first
    err = float((got.double() - want).abs().max() / want.abs().max())
    assert (err <= 2e-6) == within, err
    if terms == 1:
        assert err > 5e-5
    else:
        f32 = float(((a @ b).double() - want).abs().max() / want.abs().max())
        assert err <= 4 * max(f32, 2.0**-24)  # as good as float32 itself


@pytest.mark.parametrize("dims,batch,lanes", [
    ((384, 256, 128, 64), 1024, 1), ((384, 256, 128, 64), 1024, 30),
    ((24, 32, 16), 32, 1), ((24, 32, 16), 32, 5), ((384, 256, 128, 64), 1000, 3),
    ((384, 256, 128, 64), 1, 1), ((1024, 512, 64), 256, 30)])
def test_k1_launch_plan_fits_the_card(dims, batch, lanes):
    plan = k1_launch_plan(dims, batch, lanes)
    assert plan.slab_rows in (16, 32, 64) and plan.slabs == -(-batch // plan.slab_rows)
    assert 0 < plan.shared_bytes <= SHARED_BYTES_MAX == 232448
    assert 1 <= plan.launches <= 4
    # what the first launch leaves for the second: h and dz of every layer,
    # the dlogits, the loss partials
    rows_floats = 2 * sum(dims[1:]) + 1
    assert plan.workspace_floats >= lanes * batch * rows_floats
    assert plan.workspace_floats <= lanes * (batch * rows_floats + batch // 16 + 8 * len(dims) + 8)
    # a second-launch block per 64x64 tile of every dW, per 8 columns of every db and of dWl
    tiles = sum(-(-dims[i] // 64) * -(-dims[i + 1] // 64) for i in range(len(dims) - 1))
    assert plan.dw_blocks == tiles + sum(-(-d // 8) for d in dims[1:]) + -(-dims[-1] // 8)


def test_k1_launch_plan_picks_the_slab_by_how_full_the_card_is():
    dims = (384, 256, 128, 64)
    assert k1_launch_plan(dims, 1024, 1).slab_rows == 16   # 64 blocks on 132 SMs
    assert k1_launch_plan(dims, 1024, 5).slab_rows == 32   # 160 blocks: every SM has one
    assert k1_launch_plan(dims, 1024, 30).slab_rows == 64  # many waves: the largest slab
    assert k1_launch_plan(dims, 1024, 1, sm_count=32).slab_rows == 32
    assert k1_launch_plan((1024, 1024, 64), 1024, 30).slab_rows == 32  # 64 rows do not fit
    assert k1_launch_plan((1024, 2048, 512), 1024, 30).slab_rows == 16


@pytest.mark.parametrize("dims,batch,lanes", [
    ((384, 8192, 4096, 64), 1024, 1), ((384, 256, 128, 64), 0, 1), ((384, 256, 128, 64), 8, 0),
    ((384,), 8, 1), ((4,) * 10, 8, 1), ((384, 0, 64), 8, 1)])
def test_k1_launch_plan_refuses_what_the_kernel_does_not_take(dims, batch, lanes):
    """A tower too wide for any slab raises (no other route is taken for a
    CUDA tensor), as do an empty batch, no lane, no layer, too many layers."""
    with pytest.raises(ValueError):
        k1_launch_plan(dims, batch, lanes)
