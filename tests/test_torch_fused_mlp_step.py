"""The fused tower step of the port vs the JAX package's Pallas kernel.

CPU: ``tower_grad_reference`` (the plain version K1 is held to) against
``_fused_tower_grad(..., interpret=True)`` on the same inputs and seeds, and
the port's ``make_fast_loss_grad`` against ``maybe_make_fast_loss_grad``
(interpret mode) on converted params. Tolerance rtol 2e-5 (the JAX
package's own CPU bound for this kernel, tests/test_fused_mlp_step.py):
both run float32 matmuls, summed in different orders.

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
from mamdr_tpu_torch.ops.fused_mlp_step import (
    make_fast_loss_grad,
    tower_grad_reference,
)
from mamdr_tpu_torch.train.steps import StepConfig
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
