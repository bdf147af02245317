"""The port's zoo models vs the flax models, the nine without batch
statistics: WDL, DeepFM, NFM, AutoInt, CCPM, PNN, SharedBottom, MMoE, PLE.

At small size (3 domains, 8-d tables drawn N(0, 0.1), hidden [16, 8], MTL
towers [8], 3 experts, a gate DNN [8], PLE 2 specific + 1 shared experts),
with the JAX parameters carried across by ``convert.params_from_jax``:

- the parameter tree: the same names in the same (JAX) leaf order, the same
  shapes;
- forward logits at rtol 2e-5 (float32 sums in another order);
- the loss gradient by autograd (``make_autograd_loss_grad``) against
  ``jax.grad`` of the JAX loss, frozen and trainable tables: rtol 2e-5 /
  atol 1e-6; ``None`` at exactly the frozen tables (the linear user / item
  ones too), where the JAX package's optimizer masks them;
- the lane forward (``apply_lanes``) at L = 3, lane-stacked leaves mixed with
  leaves every lane reads, with per-lane dropout seeds, against the one-tower
  forward of each lane; and the lane gradient against each lane's (the MLP
  too);
- hash dropout with injected seeds: the JAX model's ``key_to_seed`` is
  replaced by one handing out the same seeds in call order, so both draw the
  same masks (bit-equal by ``ops/fast_random``); the JAX model calls exactly
  ``n_dropout_sites`` dropout layers;
- the initialisers: for every kernel shape of the nine, the port's draw
  has flax's ``variance_scaling`` scale (fans times the receptive field),
  checked against JAX's own fan computation and, by the empirical std of
  large draws, within 5% of flax's draws of the same shape; CCPM's conv
  kernel is ``lecun_normal``;
- PLE with ``num_levels`` 2 (the corpus runs 1), forward and gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.nn.initializers import _compute_fans

import mamdr_tpu.ops.fast_random as jfast_random
from mamdr_tpu.config import ExperimentConfig as JConfig
from mamdr_tpu.models.zoo import build_model as jax_build_model
from mamdr_tpu.train.steps import StepConfig as JStepConfig
from mamdr_tpu.train.steps import make_loss_fn as jax_make_loss_fn
from mamdr_tpu.utils import trees as jtrees
from mamdr_tpu_torch.config import ExperimentConfig
from mamdr_tpu_torch.convert import params_from_jax, params_to_numpy
from mamdr_tpu_torch.models import layers
from mamdr_tpu_torch.models.zoo import build_model
from mamdr_tpu_torch.train.steps import StepConfig, make_autograd_loss_grad
from mamdr_tpu_torch.utils import trees

ZOO = ["wdl", "deepfm", "nfm", "autoint", "ccpm", "pnn", "shared_bottom", "mmoe", "ple"]
N_UID, N_PID, N_DOM, BATCH, DIM = 40, 50, 3, 24, 8
FROZEN = {"embedding/user_emb", "embedding/item_emb", "linear/linear_user_emb",
          "linear/linear_item_emb"}


def model_dict(name, dropout=0.0, **extra):
    return {"name": name, "user_dim": DIM, "item_dim": DIM, "domain_dim": DIM,
            "hidden_dim": [16, 8], "dropout": dropout, "tower_hidden_dim": [8],
            "num_experts": 3, "gate_dnn_hidden_units": [8], "specific_expert_num": 2,
            "shared_expert_num": 1, "num_levels": 1, **extra}


def make_models(name, dropout=0.0, seed=0, **extra):
    """(flax model, port model, JAX params (numpy), port params, batch)."""
    d = {"model": model_dict(name, dropout, **extra), "train": {"load_pretrain_emb": True},
         "dataset": {"name": "synthetic"}}
    rng = np.random.default_rng(seed)
    pu = rng.normal(0, 0.1, (N_UID, DIM)).astype(np.float32)
    pi = rng.normal(0, 0.1, (N_PID, DIM)).astype(np.float32)
    jmodel = jax_build_model(JConfig.from_dict(d), N_UID, N_PID, N_DOM, pu, pi)
    tmodel = build_model(ExperimentConfig.from_dict(d), N_UID, N_PID, N_DOM, pu, pi,
                         generator=torch.Generator().manual_seed(seed))
    batch = {
        "uid": rng.integers(-2, N_UID + 2, BATCH).astype(np.int32),
        "pid": rng.integers(0, N_PID, BATCH).astype(np.int32),
        "domain": np.full(BATCH, 1, np.int32),
        "label": rng.integers(0, 2, BATCH).astype(np.float32),
        "weight": (rng.random(BATCH) > 0.2).astype(np.float32),
    }
    jparams = jax.device_get(jmodel.init(
        {"params": jax.random.PRNGKey(seed)}, jnp.asarray(batch["uid"]),
        jnp.asarray(batch["pid"]), jnp.asarray(batch["domain"]))["params"])
    # the domain and linear tables at a scale where they move the logit
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    jparams["embedding"]["domain_emb"] = rng.normal(0, 0.1, (N_DOM, DIM)).astype(np.float32)
    if "linear" in jparams:
        for k in jparams["linear"]:
            jparams["linear"][k] = rng.normal(0, 0.1, jparams["linear"][k].shape).astype(
                np.float32)
    return jmodel, tmodel, jparams, params_from_jax(jparams), batch


def jnamed(tree):
    return dict(zip(jtrees.param_names(tree), jax.tree_util.tree_leaves(tree)))


def tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("name", ZOO)
def test_param_tree_matches_flax(name):
    _, tmodel, jparams, tparams, _ = make_models(name)
    want = jnamed(jparams)
    got = dict(trees.leaves_with_names(tmodel.param_tree()))
    assert list(got) == list(want)  # same names, same (JAX) leaf order
    for n, leaf in got.items():
        assert tuple(leaf.shape) == tuple(want[n].shape), n
    # the JAX tree converts to exactly the port's names and shapes, and back
    assert trees.param_names(tparams) == list(want)
    for n, leaf in trees.leaves_with_names(params_to_numpy(tparams)):
        np.testing.assert_array_equal(leaf, want[n])
    if name == "ccpm":  # flax's HWIO layout, not transposed
        assert tuple(got["conv_0/kernel"].shape) == (3, 1, 1, 4)
        assert tuple(got["conv_1/kernel"].shape) == (1, 1, 4, 4)


@pytest.mark.parametrize("name", ZOO)
def test_forward_matches_flax(name):
    jmodel, tmodel, jparams, tparams, batch = make_models(name)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = np.asarray(jmodel.apply({"params": jparams}, jb["uid"], jb["pid"], jb["domain"]))
    tb = tbatch(batch)
    got = tmodel.apply(tparams, tb["uid"], tb["pid"], tb["domain"]).detach().numpy()
    assert np.abs(want).max() > 1e-3  # the logits are not all near zero
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-7)


def _grads_close(tgrads, jgrads, emb_trainable):
    jg = jnamed(jgrads)
    for n, g in trees.leaves_with_names(tgrads):
        if not emb_trainable and n.split("/", 1)[1] in FROZEN:
            assert g is None, n
            continue
        assert g is not None, n
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[n]), rtol=2e-5, atol=1e-6,
                                   err_msg=n)


@pytest.mark.parametrize("emb_trainable", [False, True])
@pytest.mark.parametrize("name", ZOO)
def test_loss_gradient_matches_jax(name, emb_trainable):
    jmodel, tmodel, jparams, tparams, batch = make_models(name)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss_fn = jax_make_loss_fn(jmodel, JStepConfig(emb_trainable=emb_trainable))
    (jloss, (_, _, jdata)), jg = jax.value_and_grad(jloss_fn, has_aux=True)(
        {"model": jparams}, {}, jb, jax.random.PRNGKey(0), False)
    cfg = StepConfig(emb_trainable=emb_trainable)
    tdata, tg = make_autograd_loss_grad(tmodel, cfg)({"model": tparams}, tbatch(batch), None,
                                                     train=False)
    np.testing.assert_allclose(float(tdata), float(jdata), rtol=2e-5)
    _grads_close(tg, jg, emb_trainable)


def _lane_params(tmodel, tparams, lanes):
    """Lane-stacked params: each trainable leaf stacked over the lanes with a
    per-lane change, except the logit's kernel (or towers' logit), which every
    lane reads; the frozen user/item tables stay shared."""
    shared = ("embedding/user_emb", "embedding/item_emb", "linear/linear_user_emb",
              "logit/Dense_0/Dense_0/kernel", "towers/tower_logit")

    def stack(n, x):
        if n in shared:
            return x
        return torch.stack([x * (1.0 + 0.2 * lane) + 0.01 * lane for lane in range(lanes)])

    return trees.named_tree_map(stack, tparams)


def _lane(tmodel, params, lane):
    axes = dict(trees.leaves_with_names(tmodel.lane_axes(params)))
    return trees.named_tree_map(lambda n, x: x[lane] if axes[n] == 0 else x, params)


@pytest.mark.parametrize("name", ZOO + ["mlp"])
def test_lane_forward_and_gradient_match_each_lane(name):
    lanes = 3
    _, tmodel, _, tparams, batch = make_models(name, dropout=0.5)
    params = _lane_params(tmodel, tparams, lanes)
    axes = dict(trees.leaves_with_names(tmodel.lane_axes(params)))
    assert axes["embedding/user_emb"] is None and axes["embedding/domain_emb"] == 0
    rng = np.random.default_rng(5)
    lb = {k: torch.from_numpy(np.stack([rng.permutation(v) for _ in range(lanes)]))
          for k, v in batch.items()}
    lb["domain"] = torch.arange(lanes, dtype=torch.int32)[:, None].expand(lanes, BATCH)
    lb["domain"] = lb["domain"].contiguous()
    seeds = torch.tensor(rng.integers(0, 2**32, (lanes, tmodel.n_dropout_sites)))
    for s in (None, seeds):
        got = tmodel.apply_lanes(params, lb["uid"], lb["pid"], lb["domain"], seeds=s)
        want = torch.stack([
            tmodel.apply(_lane(tmodel, params, lane), lb["uid"][lane], lb["pid"][lane],
                         lb["domain"][lane], None if s is None else s[lane])
            for lane in range(lanes)])
        torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-7)
    # the lane gradient is each lane's own; a leaf every lane reads sums them
    cfg = StepConfig(emb_trainable=False)
    grad = make_autograd_loss_grad(tmodel, cfg)
    data, g = grad({"model": params}, lb, seeds, train=True)
    assert data.shape == (lanes,)
    per = [grad({"model": _lane(tmodel, params, lane)}, {k: v[lane] for k, v in lb.items()},
                seeds[lane], train=True) for lane in range(lanes)]
    torch.testing.assert_close(data, torch.stack([p[0] for p in per]), rtol=2e-6, atol=0)
    for (n, x), *ones in zip(trees.leaves_with_names(g),
                             *(trees.leaves(p[1]) for p in per)):
        if x is None:
            assert all(o is None for o in ones), n
            continue
        want = torch.stack(ones) if axes[n.split("/", 1)[1]] == 0 else sum(ones)
        torch.testing.assert_close(x, want, rtol=2e-5, atol=1e-6, msg=n)


@pytest.mark.parametrize("name", ZOO)
def test_hash_dropout_matches_jax_with_injected_seeds(name, monkeypatch):
    jmodel, tmodel, jparams, tparams, batch = make_models(name, dropout=0.5)
    seeds = np.random.default_rng(9).integers(0, 2**32, tmodel.n_dropout_sites,
                                              dtype=np.uint64)
    handed = []

    def injected(key):
        handed.append(len(handed))
        return jnp.uint32(seeds[len(handed) - 1])

    monkeypatch.setattr(jfast_random, "key_to_seed", injected)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = np.asarray(jmodel.apply({"params": jparams}, jb["uid"], jb["pid"], jb["domain"],
                                   train=True, rngs={"dropout": jax.random.PRNGKey(3)}))
    assert len(handed) == tmodel.n_dropout_sites  # the JAX model's dropout calls
    tb = tbatch(batch)
    got = tmodel.apply(tparams, tb["uid"], tb["pid"], tb["domain"],
                       torch.tensor(seeds.astype(np.int64))).detach().numpy()
    off = tmodel.apply(tparams, tb["uid"], tb["pid"], tb["domain"]).detach().numpy()
    assert not np.allclose(got, off)  # dropout did act
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-7)


def _init_kind(name):
    if name.startswith("conv_") and name.endswith("kernel"):
        return "lecun_normal"
    if name.endswith("tower_logit") or name.startswith("logit/"):
        return "glorot_normal"
    return "glorot_uniform"


def _kernel_shapes():
    """(leaf name, shape) of every kernel of the nine (small configs and a
    PLE of two levels), and the bench's rank-3/4 shapes."""
    out = {}
    for name in ZOO + ["ple2"]:
        extra = {"num_levels": 2} if name == "ple2" else {}
        _, tmodel, _, _, _ = make_models(name.rstrip("2"), **extra)
        for n, x in trees.leaves_with_names(tmodel.param_tree()):
            if "emb" not in n and "bias" not in n:
                out.setdefault((_init_kind(n), tuple(x.shape)), n)
    for shape in [(30, 256, 128), (30, 128, 1), (2, 384, 512), (30, 384, 2),
                  (30, 3, 384, 512), (30, 3, 512, 256), (3, 1, 1, 4)]:
        kind = "lecun_normal" if len(shape) == 4 and shape[1] == 1 else (
            "glorot_normal" if shape[-1] == 1 else "glorot_uniform")
        out.setdefault((kind, shape), "bench")
    return sorted(out)


def _theory_std(kind, shape):
    fan_in, fan_out = layers.fans(shape)
    assert (fan_in, fan_out) == tuple(int(f) for f in _compute_fans(shape))
    if kind == "glorot_uniform":
        return np.sqrt(6.0 / (fan_in + fan_out)) / np.sqrt(3.0)
    if kind == "glorot_normal":
        return np.sqrt(2.0 / (fan_in + fan_out))
    return np.sqrt(1.0 / fan_in)


def _pooled(draw, shape, n=60_000):
    reps = max(1, -(-n // int(np.prod(shape))))
    return np.concatenate([np.asarray(draw(i)).reshape(-1) for i in range(reps)])


@pytest.mark.parametrize("kind,shape", _kernel_shapes())
def test_initialisers_have_flax_fans(kind, shape):
    want = _theory_std(kind, shape)
    port_init = getattr(layers, kind)
    flax_init = getattr(jax.nn.initializers, kind)()
    g = torch.Generator().manual_seed(0)
    port = _pooled(lambda i: port_init(torch.empty(shape), g).numpy(), shape)
    ref = _pooled(lambda i: flax_init(jax.random.PRNGKey(i), shape, jnp.float32), shape)
    assert abs(port.std() / want - 1.0) < 0.05, (port.std(), want)
    assert abs(port.std() / ref.std() - 1.0) < 0.05, (port.std(), ref.std())
    if kind == "glorot_uniform":  # the draw's bound is the limit itself
        assert np.abs(port).max() <= want * np.sqrt(3.0) * (1 + 1e-6)
    else:  # flax's truncated normal: within 2 of its pre-truncation stddevs
        assert np.abs(port).max() <= 2.0 * want / 0.87962566103423978 * (1 + 1e-6)
    if shape == (30, 256, 128):  # the rank-3 case a rank-2 formula had 5.5x too wide
        assert want * np.sqrt(3.0) == pytest.approx(0.0228, abs=1e-4)


@pytest.mark.parametrize("emb_trainable", [False, True])
def test_ple_of_two_levels_matches_flax(emb_trainable):
    jmodel, tmodel, jparams, tparams, batch = make_models("ple", num_levels=2)
    assert "task_expert_kernel_1" in tparams and tparams["task_expert_kernel_1"].shape == (
        N_DOM, 2, 16, 8)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = np.asarray(jmodel.apply({"params": jparams}, jb["uid"], jb["pid"], jb["domain"]))
    tb = tbatch(batch)
    got = tmodel.apply(tparams, tb["uid"], tb["pid"], tb["domain"]).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-7)
    jloss_fn = jax_make_loss_fn(jmodel, JStepConfig(emb_trainable=emb_trainable))
    _, jg = jax.value_and_grad(jloss_fn, has_aux=True)(
        {"model": jparams}, {}, jb, jax.random.PRNGKey(0), False)
    _, tg = make_autograd_loss_grad(tmodel, StepConfig(emb_trainable=emb_trainable))(
        {"model": tparams}, tb, None, train=False)
    _grads_close(tg, jg, emb_trainable)
    # the last level's shared gate reaches no logit: zeros, as jax.grad gives
    assert not torch.any(tg["model"]["shared_gate_kernel_1"])
