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
  mu 1e-8 against gradients of order 1e-3, and params 1e-5 = lr/1000 —
  Adam divides by sqrt(nu), so a table row whose gradient is almost only
  its l2 term still takes a step of order lr, steered by the last bits.
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
from mamdr_tpu.train.steps import make_optimizer as jax_make_optimizer
from mamdr_tpu.train.steps import make_train_step as jax_make_train_step
from mamdr_tpu_torch.config import ExperimentConfig
from mamdr_tpu_torch.convert import params_from_jax
from mamdr_tpu_torch.models.zoo import build_model
from mamdr_tpu_torch.train.flat_optimizer import apply_updates, flat_adam
from mamdr_tpu_torch.train.state import TrainState
from mamdr_tpu_torch.train.steps import StepConfig, make_optimizer, make_train_step
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
    jtx, ttx = jax_flat_adam(1e-2, mask), flat_adam(1e-2, mask)
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


@pytest.mark.parametrize("emb_trainable", [False, True])
def test_train_steps_match_jax_and_all_pad_gate(emb_trainable):
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
    np.testing.assert_allclose(ts.opt_state.mu.numpy(), np.asarray(js.opt_state.mu),
                               rtol=2e-5, atol=1e-8)
    np.testing.assert_allclose(ts.opt_state.nu.numpy(), np.asarray(js.opt_state.nu),
                               rtol=2e-5, atol=1e-12)
    jnamed = dict(zip(trees.param_names(jax.device_get(js.params)),
                      jax.tree_util.tree_leaves(js.params)))
    for name, leaf in trees.leaves_with_names(ts.params):
        np.testing.assert_allclose(leaf.numpy(), np.asarray(jnamed[name]),
                                   rtol=2e-5, atol=1e-5, err_msg=name)
