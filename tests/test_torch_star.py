"""The port's STAR (``models/star.py``) vs the flax model, with its batch
statistics.

At small size (3 domains, 8-d tables drawn N(0, 0.1), hidden [16, 8],
auxiliary width 8), the JAX parameters and statistics carried across by
``convert.params_from_jax`` / ``convert.batch_stats_from_jax``. Every
parameter and statistic is drawn away from its init (specific gammas and
betas, biases, moving means and variances), so each term reaches the
result:

- the parameter and statistics trees: the same flax names in the same leaf
  order, the same shapes;
- each layer alone — StarFCN, AuxiliaryNet, PartitionedNorm and BatchNorm,
  the norms in train and eval mode — against the flax module;
- ``Star``'s forward in eval and train mode (logits and new statistics) and
  its loss gradient (``make_autograd_loss_grad``, train mode, the norms'
  batch statistics in the graph) against ``jax.value_and_grad`` of the JAX
  loss, for every ``norm`` x ``dense`` x ``auxiliary_net``;
- two train steps (``make_train_step``: SGD, the gate) against JAX
  ``make_train_step``: params and statistics, and training on domain
  d moves only row d of PartitionedNorm's moving statistics (as
  tests/test_models.py holds the JAX model to it); an all-pad batch leaves
  the statistics bit-equal;
- the lane forward (``apply_lanes``) with lane-stacked and shared
  statistics, in train and eval mode, against each lane's one-tower forward;
- the initialisers: Keras' embedding uniform(-0.05, 0.05), and glorot on the
  rank-3 specific kernels with flax's fans (times the receptive field).

Tolerance: rtol 2e-5 / atol 1e-5 (float32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.nn.initializers import _compute_fans

from mamdr_tpu.config import ExperimentConfig as JConfig
from mamdr_tpu.models import star as jstar
from mamdr_tpu.models.zoo import build_model as jax_build_model
from mamdr_tpu.train.state import TrainState as JTrainState
from mamdr_tpu.train.steps import StepConfig as JStepConfig
from mamdr_tpu.train.steps import make_loss_fn as jax_make_loss_fn
from mamdr_tpu.train.steps import make_optimizer as jax_make_optimizer
from mamdr_tpu.train.steps import make_train_step as jax_make_train_step
from mamdr_tpu.utils import trees as jtrees
from mamdr_tpu_torch.config import ExperimentConfig
from mamdr_tpu_torch.convert import batch_stats_from_jax, params_from_jax
from mamdr_tpu_torch.models import layers, star
from mamdr_tpu_torch.models.zoo import build_model
from mamdr_tpu_torch.train.state import TrainState
from mamdr_tpu_torch.train.steps import (
    StepConfig,
    make_autograd_loss_grad,
    make_optimizer,
    make_train_step,
)
from mamdr_tpu_torch.utils import trees

N_UID, N_PID, N_DOM, BATCH, DIM = 40, 50, 3, 24, 8
RTOL, ATOL = 2e-5, 1e-5
FROZEN = {"user_emb", "item_emb"}
COMBOS = [(n, d, a) for n in ("pn", "bn", "none") for d in ("star", "dense")
          for a in (False, True)]


def model_dict(norm="pn", dense="star", aux=False):
    return {"name": "star", "user_dim": DIM, "item_dim": DIM, "domain_dim": DIM,
            "hidden_dim": [16, 8], "auxiliary_dim": 8, "norm": norm, "dense": dense,
            "auxiliary_net": aux}


def _perturb(tree, rng):
    """Every leaf drawn away from its init: tables and kernels N(0, 0.1)
    (kernels around their glorot draw), gammas and variances around 1."""
    def leaf(name, x):
        x = np.asarray(x)
        if name in FROZEN:
            return x
        if "gamma" in name or name.endswith("scale") or name.endswith("var"):
            return (1.0 + rng.uniform(-0.3, 0.3, x.shape)).astype(np.float32)
        if "kernel" in name:
            return (x + rng.normal(0, 0.05, x.shape)).astype(np.float32)
        return rng.normal(0, 0.1, x.shape).astype(np.float32)

    return jtrees.named_tree_map(leaf, jax.device_get(tree))


def make_models(norm="pn", dense="star", aux=False, seed=0, domain=1):
    """(flax model, port model, JAX params, JAX stats, port params, port
    stats, batch)."""
    d = {"model": model_dict(norm, dense, aux), "train": {"load_pretrain_emb": True},
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
        "domain": np.full(BATCH, domain, np.int32),
        "label": rng.integers(0, 2, BATCH).astype(np.float32),
        "weight": (rng.random(BATCH) > 0.2).astype(np.float32),
    }
    variables = jmodel.init({"params": jax.random.PRNGKey(seed)}, jnp.asarray(batch["uid"]),
                            jnp.asarray(batch["pid"]), jnp.asarray(batch["domain"]))
    jparams = jax.tree_util.tree_map(jnp.asarray, _perturb(variables["params"], rng))
    jstats = jax.tree_util.tree_map(jnp.asarray,
                                    _perturb(dict(variables.get("batch_stats", {})), rng))
    return (jmodel, tmodel, jparams, jstats, params_from_jax(jparams),
            batch_stats_from_jax(jstats), batch)


def jnamed(tree):
    return dict(zip(jtrees.param_names(tree), jax.tree_util.tree_leaves(tree)))


def tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def trees_close(got, want, msg=""):
    want = jnamed(want)
    assert trees.param_names(got) == list(want), msg
    for n, x in trees.leaves_with_names(got):
        np.testing.assert_allclose(x.detach().numpy(), np.asarray(want[n]), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{msg} {n}")


@pytest.mark.parametrize("norm,dense", [("pn", "star"), ("bn", "dense"), ("none", "star")])
def test_param_and_stats_trees_match_flax(norm, dense):
    _, tmodel, jparams, jstats, tparams, tstats, _ = make_models(norm, dense)
    want = jnamed(jparams)
    got = dict(trees.leaves_with_names(tmodel.param_tree()))
    assert list(got) == list(want)  # the same names, in JAX's leaf order
    for n, leaf in got.items():
        assert tuple(leaf.shape) == tuple(want[n].shape), n
    assert trees.param_names(tparams) == list(want)
    want_stats = jnamed(jstats)
    init = dict(trees.leaves_with_names(tmodel.init_stats()))
    assert list(init) == list(want_stats) == trees.param_names(tstats)
    for n, leaf in init.items():
        assert tuple(leaf.shape) == tuple(want_stats[n].shape), n
    assert tmodel.has_batch_stats == (norm != "none") and tmodel.n_dropout_sites == 0
    if dense == "star":  # the corpus's meta_parms: the shared star weights and the tables
        mask = trees.meta_parm_mask({"model": tmodel.param_tree()},
                                    ["emb", "kernel_shared", "bias_shared"])
        picked = {n for n, m in trees.leaves_with_names(mask) if m}
        assert picked == {"model/user_emb", "model/item_emb", "model/domain_emb",
                          "model/star_fcn_0/kernel_shared", "model/star_fcn_0/bias_shared",
                          "model/star_fcn_1/kernel_shared", "model/star_fcn_1/bias_shared"}


def test_initial_stats_and_initialisers():
    """PartitionedNorm's stats start at zeros / ones a domain, BatchNorm's
    likewise; the tables draw Keras' uniform(-0.05, 0.05), the specific
    kernels glorot with flax's fans (the receptive field counts)."""
    jmodel, tmodel, *_ = make_models("pn", "star")
    ids = jnp.zeros((4,), jnp.int32)
    jinit = jax.device_get(jmodel.init({"params": jax.random.PRNGKey(0)}, ids, ids, ids))
    for n, x in trees.leaves_with_names(tmodel.init_stats()):
        np.testing.assert_array_equal(x.numpy(), np.asarray(jnamed(jinit["batch_stats"])[n]))
    big = star.Star(20_000, 20_000, 30, hidden_dim=(64,), norm="pn", dense="star",
                    auxiliary_dim=64, generator=torch.Generator().manual_seed(1))
    tree = dict(trees.leaves_with_names(big.param_tree()))
    for name in ("user_emb", "domain_emb"):
        x = tree[name]
        assert float(x.min()) >= -0.05 and float(x.max()) <= 0.05
        assert abs(float(x.max()) - 0.05) < 1e-3 and abs(float(x.mean())) < 2e-3
    jtable = np.asarray(jstar.keras_embedding_init(jax.random.PRNGKey(0), (20_000, 128)))
    assert jtable.min() >= -0.05 and jtable.max() <= 0.05 and abs(jtable.mean()) < 1e-3
    for name in ("star_fcn_0/kernel_specific", "auxiliary_net/kernel_specific",
                 "star_fcn_0/kernel_shared", "head/Dense_0/kernel"):
        x = tree[name]
        fan_in, fan_out = _compute_fans(tuple(x.shape), -2, -1, ())
        assert layers.fans(x.shape) == (fan_in, fan_out), name
        limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
        assert float(x.abs().max()) <= limit and float(x.abs().max()) > 0.95 * limit, name
    for name in ("partitioned_norm/gamma_specific", "partitioned_norm/gamma_shared"):
        assert bool((tree[name] == 1).all())
    assert not any(bool(tree[n].any()) for n in tree if "bias" in n or "beta" in n)


def _flax_layer(kind, jparams, jstats):
    """(flax module, its variables, port module, its params, its stats,
    input width) for one layer of a pn/star model with auxiliary net."""
    width = 3 * DIM
    if kind == "star_fcn":
        return (jstar.StarFCN(N_DOM, 16), {"params": jparams["star_fcn_0"]},
                star.StarFCN(N_DOM, width, 16), jparams["star_fcn_0"], None)
    if kind == "auxiliary_net":
        return (jstar.AuxiliaryNet(N_DOM, 8), {"params": jparams["auxiliary_net"]},
                star.AuxiliaryNet(N_DOM, width, 8), jparams["auxiliary_net"], None)
    if kind == "pn":
        return (jstar.PartitionedNorm(N_DOM),
                {"params": jparams["partitioned_norm"],
                 "batch_stats": jstats["partitioned_norm"]},
                star.PartitionedNorm(N_DOM, width), jparams["partitioned_norm"],
                jstats["partitioned_norm"])
    import flax.linen as fnn

    return (fnn.BatchNorm(momentum=0.99, epsilon=1e-3),
            {"params": jparams["bn"], "batch_stats": jstats["bn"]},
            star.BatchNorm(width), jparams["bn"], jstats["bn"])


@pytest.mark.parametrize("kind,train", [("star_fcn", False), ("auxiliary_net", False),
                                        ("pn", False), ("pn", True), ("bn", False),
                                        ("bn", True)])
def test_layer_matches_flax(kind, train):
    norm = "bn" if kind == "bn" else "pn"
    _, _, jparams, jstats, *_ = make_models(norm, "star", aux=True)
    fmod, variables, tmod, tp, ts = _flax_layer(kind, jparams, jstats)
    variables = jax.tree_util.tree_map(jnp.asarray, variables)
    x = np.random.default_rng(3).normal(0.2, 1.5, (BATCH, 3 * DIM)).astype(np.float32)
    idx = 2
    tx, tidx = torch.from_numpy(x), torch.tensor([idx])
    params = {k.replace("/", "."): v for k, v in
              trees.leaves_with_names(params_from_jax(tp))}
    if kind in ("star_fcn", "auxiliary_net"):
        want = fmod.apply(variables, jnp.asarray(x), jnp.int32(idx))
        got = torch.func.functional_call(tmod, params, (tx, tidx))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
        return
    if kind == "pn":
        out = fmod.apply(variables, jnp.asarray(x), jnp.int32(idx), train,
                         mutable=["batch_stats"] if train else False)
    else:
        fmod = fmod.clone(use_running_average=not train)
        out = fmod.apply(variables, jnp.asarray(x), mutable=["batch_stats"] if train else False)
    want, new = out if train else (out, {"batch_stats": jstats[kind if kind == "bn" else
                                                                 "partitioned_norm"]})
    got, got_stats = torch.func.functional_call(tmod, params,
                                                (tx, tidx, batch_stats_from_jax(ts), train))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    want_stats = new["batch_stats"] if train else ts
    for n, v in trees.leaves_with_names(got_stats):
        np.testing.assert_allclose(v.numpy(), np.asarray(jnamed(want_stats)[n]),
                                   rtol=RTOL, atol=ATOL, err_msg=n)


def _grads_close(tgrads, jgrads, emb_trainable):
    jg = jnamed(jgrads)
    for n, g in trees.leaves_with_names(tgrads):
        if not emb_trainable and n.split("/", 1)[1] in FROZEN:
            assert g is None, n
            continue
        assert g is not None, n
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[n]), rtol=RTOL, atol=ATOL,
                                   err_msg=n)


@pytest.mark.parametrize("norm,dense,aux", COMBOS)
def test_star_forward_and_gradient_match_flax(norm, dense, aux):
    """Eval-mode and train-mode logits, the new statistics, and the train-mode
    loss gradient (frozen tables) of every configuration."""
    jmodel, tmodel, jparams, jstats, tparams, tstats, batch = make_models(norm, dense, aux)
    jb, tb = jbatch(batch), tbatch(batch)
    variables = {"params": jparams, **({"batch_stats": jstats} if jstats else {})}
    want = np.asarray(jmodel.apply(variables, jb["uid"], jb["pid"], jb["domain"]))
    kw = {"stats": tstats} if tmodel.has_batch_stats else {}
    got = tmodel.apply(tparams, tb["uid"], tb["pid"], tb["domain"], **kw)
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=ATOL)
    if tmodel.has_batch_stats:
        jlogits, jnew = jmodel.apply(variables, jb["uid"], jb["pid"], jb["domain"],
                                     train=True, mutable=["batch_stats"])
        tlogits, tnew = tmodel.apply(tparams, tb["uid"], tb["pid"], tb["domain"],
                                     stats=tstats, train=True)
        np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits), rtol=RTOL,
                                   atol=ATOL)
        trees_close(tnew, jnew["batch_stats"], "train stats")

    jcfg = JStepConfig(emb_trainable=False, has_batch_stats=bool(jstats))
    (_, (jnew_stats, _, jdata)), jg = jax.value_and_grad(
        jax_make_loss_fn(jmodel, jcfg), has_aux=True)(
        {"model": jparams}, jstats, jb, jax.random.PRNGKey(0), True)
    out = make_autograd_loss_grad(tmodel, StepConfig(emb_trainable=False))(
        {"model": tparams}, tb, None, train=True, **kw)
    np.testing.assert_allclose(float(out[0]), float(jdata), rtol=RTOL)
    _grads_close(out[1], jg, emb_trainable=False)
    if tmodel.has_batch_stats:
        trees_close(out[2], jnew_stats, "loss-grad stats")
        assert all(not x.requires_grad for x in trees.leaves(out[2]))


def _states(jparams, jstats, emb_trainable):
    """(JAX optimizer, JAX state, port optimizer, port state) on the same
    params and statistics, with plain SGD: a normalised domain column is
    constant in a one-domain batch, so its gamma gradient is float rounding
    noise, which Adam would scale up to steps of order lr on either side."""
    jp = {"model": jparams}
    jtx = jax_make_optimizer("sgd", 0.1, jp, emb_trainable)
    jstate = JTrainState.create(jp, jtx.init(jp), jstats, jax.random.PRNGKey(0))
    tp = {"model": params_from_jax(jparams)}
    ttx = make_optimizer("sgd", 0.1, tp, emb_trainable)
    tstate = TrainState.create(tp, ttx.init(tp), 0, "cpu",
                               batch_stats=batch_stats_from_jax(jstats))
    return jtx, jstate, ttx, tstate


@pytest.mark.parametrize("emb_trainable", [False, True])
@pytest.mark.parametrize("norm", ["pn", "bn"])
def test_train_step_matches_jax_and_moves_only_its_domain_row(norm, emb_trainable):
    jmodel, tmodel, jparams, jstats, _, _, batch = make_models(norm, "star", domain=2)
    jtx, jstate, ttx, tstate = _states(jparams, jstats, emb_trainable)
    jcfg = JStepConfig(emb_trainable=emb_trainable, has_batch_stats=True)
    jstep, _ = jax_make_train_step(jmodel, jtx, jcfg)
    tstep = make_train_step(tmodel, ttx, StepConfig(emb_trainable=emb_trainable))
    for _ in range(2):
        jstate, jloss = jstep(jstate, jbatch(batch))
        tstate, tloss = tstep(tstate, tbatch(batch))
        np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=RTOL)
    trees_close(tstate.params, jax.device_get(jstate.params), "params")
    trees_close(tstate.batch_stats, jax.device_get(jstate.batch_stats), "stats")
    assert int(tstate.step) == 2
    for n, x in trees.leaves_with_names(tstate.params):
        if not emb_trainable and ("user_emb" in n or "item_emb" in n):
            assert torch.equal(x, params_from_jax(jnamed(jparams)[n.split("/", 1)[1]]))
    if norm == "pn":
        start = batch_stats_from_jax(jstats)["partitioned_norm"]
        for key in ("moving_mean", "moving_var"):
            now = tstate.batch_stats["partitioned_norm"][key]
            assert torch.equal(now[:2], start[key][:2]), key  # rows 0 and 1 untouched
            assert not torch.equal(now[2], start[key][2]), key


@pytest.mark.parametrize("norm", ["pn", "bn"])
def test_all_pad_batch_keeps_the_stats_bit_equal(norm):
    jmodel, tmodel, jparams, jstats, _, _, batch = make_models(norm, "star")
    _, _, ttx, tstate = _states(jparams, jstats, False)
    tstep = make_train_step(tmodel, ttx, StepConfig(emb_trainable=False))
    pad = dict(tbatch(batch), weight=torch.zeros(BATCH))
    new, _ = tstep(tstate, pad)
    for a, b in zip(trees.leaves(new.batch_stats), trees.leaves(tstate.batch_stats)):
        assert torch.equal(a, b)
    for a, b in zip(trees.leaves(new.params), trees.leaves(tstate.params)):
        assert torch.equal(a, b)
    assert int(new.step) == 0
    # a batch with data does move them
    moved, _ = tstep(tstate, tbatch(batch))
    assert any(not torch.equal(a, b) for a, b in zip(trees.leaves(moved.batch_stats),
                                                      trees.leaves(tstate.batch_stats)))


def _lane(tmodel, params, lane):
    axes = dict(trees.leaves_with_names(tmodel.lane_axes(params)))
    return trees.named_tree_map(lambda n, x: x[lane] if axes[n] == 0 else x, params)


@pytest.mark.parametrize("norm", ["pn", "bn"])
def test_lane_forward_matches_each_lane(norm):
    """apply_lanes over 3 lanes (each its own domain; the specific kernels,
    the domain table and the statistics lane-stacked, the frozen tables
    shared) against each lane's one-tower apply: eval mode with one shared
    statistics tree and with stacked ones, train mode with stacked ones."""
    lanes = 3
    _, tmodel, _, _, tparams, tstats, batch = make_models(norm, "star", aux=True)
    params = trees.named_tree_map(
        lambda n, x: x if n in FROZEN else torch.stack(
            [x * (1.0 + 0.2 * lane) + 0.01 * lane for lane in range(lanes)]), tparams)
    stacked = trees.tree_map(lambda x: torch.stack([x + 0.1 * lane for lane in range(lanes)]),
                             tstats)
    rng = np.random.default_rng(5)
    lb = {k: torch.from_numpy(np.stack([rng.permutation(v) for _ in range(lanes)]))
          for k, v in batch.items()}
    lb["domain"] = torch.arange(lanes, dtype=torch.int32)[:, None].expand(lanes, BATCH)
    lb["domain"] = lb["domain"].contiguous()

    def one(lane, stats, train):
        return tmodel.apply(_lane(tmodel, params, lane), lb["uid"][lane], lb["pid"][lane],
                            lb["domain"][lane], stats=stats, train=train)

    got = tmodel.apply_lanes(params, lb["uid"], lb["pid"], lb["domain"], stats=tstats)
    want = torch.stack([one(lane, tstats, False) for lane in range(lanes)])
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    got = tmodel.apply_lanes(params, lb["uid"], lb["pid"], lb["domain"], stats=stacked)
    lane_stats = [trees.tree_map(lambda x: x[lane], stacked) for lane in range(lanes)]
    want = torch.stack([one(lane, lane_stats[lane], False) for lane in range(lanes)])
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    got, new = tmodel.apply_lanes(params, lb["uid"], lb["pid"], lb["domain"], stats=stacked,
                                  train=True)
    per = [one(lane, lane_stats[lane], True) for lane in range(lanes)]
    torch.testing.assert_close(got, torch.stack([p[0] for p in per]), rtol=RTOL, atol=ATOL)
    for (n, x), *ones in zip(trees.leaves_with_names(new),
                             *(trees.leaves(p[1]) for p in per)):
        torch.testing.assert_close(x, torch.stack(ones), rtol=RTOL, atol=ATOL, msg=n)


def test_loss_gradient_at_a_zero_logit_matches_jax():
    """STAR's head starts with a zero bias, so a row whose ReLUs are all dead
    has a logit of exactly 0. The loss's gradient there is σ(0) - y = 0.5 - y,
    as ``jax.grad`` of the JAX package's ``weighted_bce`` gives; values and
    gradients elsewhere agree too."""
    from mamdr_tpu.train.steps import weighted_bce as jax_weighted_bce
    from mamdr_tpu_torch.train.steps import weighted_bce

    z = np.array([0.0, 0.0, -0.0, 3.5, -2.0, 30.0, -30.0, 1e-8], np.float32)
    y = np.array([0, 1, 1, 1, 0, 0, 1, 1], np.float32)
    w = np.array([1, 1, 1, 1, 1, 1, 1, 0], np.float32)
    jloss, jgrad = jax.value_and_grad(jax_weighted_bce)(jnp.asarray(z), jnp.asarray(y),
                                                         jnp.asarray(w))
    tz = torch.from_numpy(z).requires_grad_(True)
    tloss = weighted_bce(tz, torch.from_numpy(y), torch.from_numpy(w))
    (tgrad,) = torch.autograd.grad(tloss, tz)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=RTOL)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(tgrad.numpy()[:3], (0.5 - y[:3]) / 7.0, rtol=1e-6)
