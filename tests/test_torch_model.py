"""The port's MLP vs the flax MLP: parameter names and shapes, and logits on
the same (converted) parameters. Tolerance rtol 2e-5: float32 matmuls summed
in different orders."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamdr_tpu.config import ExperimentConfig as JConfig
from mamdr_tpu.models.zoo import build_model as jax_build_model
from mamdr_tpu.train.steps import StepConfig as JStepConfig
from mamdr_tpu.train.steps import make_loss_fn as jax_make_loss_fn
from mamdr_tpu.utils import trees as jtrees
from mamdr_tpu_torch.config import ExperimentConfig
from mamdr_tpu_torch.convert import params_from_jax, params_to_numpy
from mamdr_tpu_torch.models.zoo import build_model
from mamdr_tpu_torch.train.steps import StepConfig, make_loss_fn
from mamdr_tpu_torch.utils import trees

N_UID, N_PID, N_DOM, BATCH = 50, 60, 3, 32


def _setup(pretrained: bool):
    d = {
        "model": {"name": "mlp_meta_mamdr_finetune", "user_dim": 8, "item_dim": 8,
                  "domain_dim": 8, "hidden_dim": [32, 16], "dropout": 0.5},
        "train": {"load_pretrain_emb": pretrained},
        "dataset": {"name": "synthetic"},
    }
    rng = np.random.default_rng(1)
    pu = rng.normal(0, 0.1, (N_UID, 8)).astype(np.float32) if pretrained else None
    pi = rng.normal(0, 0.1, (N_PID, 8)).astype(np.float32) if pretrained else None
    jmodel = jax_build_model(JConfig.from_dict(d), N_UID, N_PID, N_DOM, pu, pi)
    tmodel = build_model(ExperimentConfig.from_dict(d), N_UID, N_PID, N_DOM, pu, pi,
                         generator=torch.Generator().manual_seed(0))
    batch = {
        "uid": rng.integers(-3, N_UID + 3, BATCH).astype(np.int32),
        "pid": rng.integers(0, N_PID, BATCH).astype(np.int32),
        "domain": np.full(BATCH, 2, np.int32),
        "label": rng.integers(0, 2, BATCH).astype(np.float32),
        "weight": np.ones(BATCH, np.float32),
    }
    jparams = jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
        jnp.asarray(batch["uid"]), jnp.asarray(batch["pid"]),
        jnp.asarray(batch["domain"]), train=False,
    )["params"]
    return jmodel, tmodel, jparams, batch, pu


@pytest.mark.parametrize("pretrained", [False, True])
def test_param_names_shapes_and_init(pretrained):
    jmodel, tmodel, jparams, _, pu = _setup(pretrained)
    jnamed = dict(zip(jtrees.param_names(jparams), jax.tree_util.tree_leaves(jparams)))
    tnamed = dict(trees.leaves_with_names(tmodel.param_tree()))
    assert list(tnamed) == list(jnamed)  # same names, same (JAX) leaf order
    assert "dnn/Dense_0/Dense_0/kernel" in tnamed
    assert "logit/Dense_0/Dense_0/kernel" in tnamed
    for name, leaf in tnamed.items():
        assert tuple(leaf.shape) == tuple(jnamed[name].shape), name
    # initialisers: zero biases, Keras-default kernel scales, pretrained kept
    assert not torch.any(tnamed["dnn/Dense_1/Dense_0/bias"])
    lim = np.sqrt(6.0 / (24 + 32))
    assert float(tnamed["dnn/Dense_0/Dense_0/kernel"].abs().max()) <= lim
    if pretrained:
        np.testing.assert_array_equal(tnamed["embedding/user_emb"].numpy(), pu)
    else:
        assert float(tnamed["embedding/user_emb"].std()) < 1e-3


@pytest.mark.parametrize("pretrained", [False, True])
def test_logits_and_loss_match_flax(pretrained):
    jmodel, tmodel, jparams, batch, _ = _setup(pretrained)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = np.asarray(jmodel.apply({"params": jparams}, jb["uid"], jb["pid"],
                                   jb["domain"], train=False))
    tparams = params_from_jax(jax.device_get(jparams))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = tmodel.apply(tparams, tb["uid"], tb["pid"], tb["domain"]).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-7)

    jloss, (_, _, jdata) = jax_make_loss_fn(jmodel, JStepConfig(emb_trainable=False))(
        {"model": jparams}, {}, jb, jax.random.PRNGKey(0), False)
    tloss, tdata = make_loss_fn(tmodel, StepConfig(emb_trainable=False))(
        {"model": tparams}, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=2e-5)
    np.testing.assert_allclose(float(tdata), float(jdata), rtol=2e-5)

    # conversion round-trips exactly
    back = params_to_numpy(tparams)
    for name, leaf in trees.leaves_with_names(back):
        np.testing.assert_array_equal(
            leaf, np.asarray(dict(zip(jtrees.param_names(jparams),
                                      jax.tree_util.tree_leaves(jparams)))[name]))
