"""The port's per-call route and the loops of joint, MAMDR and separate on
it, vs the JAX package's, on the CPU.

Both packages start from the same parameters (``convert.params_from_jax``;
MAMDR also from the same specific weights, STAR from the same statistics)
on the same synthetic data: 3 domains of about 200 train rows, batch 64,
hidden [16, 8], dropout off, the shuffle ON. The per-call route draws every
batch order from ``np_rng`` as the JAX package does, so whole epochs with
shuffling are held to the JAX package's same loop:

- ``Trainer.stack_split`` / ``stack_train_epoch`` against JAX
  ``stack_batches`` bit for bit, pad rows included (the rows gathered on
  the device, or staged from the host), and ``np_rng``'s state after;
- ``fit_domain`` (model optimizer and finetune SGD) and
  ``evaluate_domain``: params and Adam slots rtol 2e-5 / atol 1e-5, the
  loss rtol 2e-5, the AUC's confusion counts exact with threshold-edge rows
  set aside (``test_torch_eval.counts_agree``);
- two epochs of MAMDR's ``_train_loop`` (plain, batch update,
  ``finetune_every_epoch``, a target domain, ``fixed_train``) and joint's
  per-domain loop under ``fixed_train``: params, Adam slots, shared,
  specific, the best params, the early stop's state and ``np_rng``'s
  state (MAMDR's loop on STAR is in tests/test_torch_star_run.py, where
  the JAX package's STAR compilations are already warm);
- ``_separate_loop`` for the separate strategy and for the finetune stage;
- the routes each strategy takes, with ``fused_padding_ok`` patched.

Shared with tests/test_torch_loops_meta.py: ``loop_pair``, ``states_close``.
"""

import jax
import numpy as np
import pytest
import torch

from mamdr_tpu.config import ExperimentConfig as JConfig
from mamdr_tpu.data.dataset import stack_batches as jstack_batches
from mamdr_tpu.data.synthetic import make_synthetic_dataset as jax_make_synthetic
from mamdr_tpu.strategies import build_strategy as jbuild_strategy
from mamdr_tpu.train.checkpoints import load_pytree as jload_pytree
from mamdr_tpu.train.trainer import Trainer as JTrainer
from mamdr_tpu_torch.config import ExperimentConfig
from mamdr_tpu_torch.convert import batch_stats_from_jax, params_from_jax, specific_from_jax
from mamdr_tpu_torch.data.dataset import stack_batches
from mamdr_tpu_torch.data.synthetic import make_synthetic_dataset
from mamdr_tpu_torch.strategies import separate
from mamdr_tpu_torch.strategies.base import build_strategy
from mamdr_tpu_torch.strategies.domain_negotiation import DomainNegotiationStrategy
from mamdr_tpu_torch.strategies.joint import JointStrategy
from mamdr_tpu_torch.strategies.mamdr import MAMDRStrategy
from mamdr_tpu_torch.strategies.maml import MAMLStrategy
from mamdr_tpu_torch.strategies.pcgrad import PCGradStrategy
from mamdr_tpu_torch.strategies.reptile import ReptileStrategy
from mamdr_tpu_torch.train.trainer import Trainer
from mamdr_tpu_torch.utils import trees
from test_torch_eval import counts_agree
from test_torch_strategies import results_close

RTOL, ATOL = 2e-5, 1e-5


def loop_pair(tmp_path, name, n_per_domain=330, batch=64, fixed_train=False, model=None,
              **train):
    """(JAX trainer, JAX strategy, port trainer, port strategy) for `name`
    on the same data, parameters, statistics and (MAMDR) specific weights;
    3 domains, hidden [16, 8], dropout off, 2 epochs. ``fixed_train`` is set
    on both datasets (the JAX package reads the attribute, not the config)."""
    def config(side):
        return {
            "model": {"name": name, "user_dim": 8, "item_dim": 8, "domain_dim": 8,
                      "hidden_dim": [16, 8], "dropout": 0.0, **(model or {})},
            "train": {"load_pretrain_emb": True, "emb_trainable": False,
                      "learning_rate": 1e-2, "meta_learning_rate": 0.1, "sample_num": 2,
                      "epoch": 2, "patience": 2,
                      "checkpoint_path": str(tmp_path / side / "ckpt"),
                      "result_save_path": str(tmp_path / side / "result"), **train},
            "dataset": {"name": "synthetic", "batch_size": batch, "seed": 21},
        }

    kw = dict(n_domain=3, n_uid=50, n_pid=60, n_per_domain=n_per_domain, seed=21,
              long_tail=False, batch_size=batch)
    jds, tds = jax_make_synthetic(**kw), make_synthetic_dataset(**kw)
    for ds in (jds, tds):
        rng = np.random.default_rng(0)
        ds.user_emb = rng.normal(0, 0.1, (50, 8)).astype(np.float32)
        ds.item_emb = rng.normal(0, 0.1, (60, 8)).astype(np.float32)
        ds.fixed_train = fixed_train
    jt = JTrainer(JConfig.from_dict(config("jax")), jds, verbose=False)
    js = jbuild_strategy(jt)
    tt = Trainer(ExperimentConfig.from_dict(config("port")), tds, device="cpu", verbose=False)
    tt.state = tt.state.replace(
        params=params_from_jax(jax.device_get(jt.state.params)),
        batch_stats=batch_stats_from_jax(jax.device_get(jt.state.batch_stats)))
    ts = build_strategy(tt)
    if isinstance(ts, MAMDRStrategy):
        ts.specific = specific_from_jax(jax.device_get(js.specific), ts.mask, ts.shared)
        ts.best_specific = list(ts.specific)
    return jt, js, tt, ts


def trees_close(port_tree, jax_tree, what, rtol=RTOL, atol=ATOL):
    named = dict(zip(trees.param_names(jax.device_get(jax_tree)),
                     jax.tree_util.tree_leaves(jax_tree)))
    assert trees.param_names(port_tree) == list(named), what
    for name, leaf in trees.leaves_with_names(port_tree):
        np.testing.assert_allclose(leaf.numpy(), np.asarray(named[name]), rtol=rtol,
                                   atol=atol, err_msg=f"{what}:{name}")


def states_close(jt, tt, rtol=RTOL, atol=ATOL):
    """Params, optimizer slots (flat Adam), step, batch statistics, the best
    params, the early stop and np_rng of the two trainers."""
    trees_close(tt.state.params, jt.state.params, "params", rtol, atol)
    if hasattr(tt.state.opt_state, "mu"):
        jopt = jax.device_get(jt.state.opt_state)
        assert int(tt.state.opt_state.count) == int(jopt.count)
        for k in ("mu", "nu"):
            np.testing.assert_allclose(getattr(tt.state.opt_state, k).numpy(),
                                       getattr(jopt, k), rtol=rtol, atol=atol, err_msg=k)
    assert int(tt.state.step) == int(jt.state.step)
    if tt.state.batch_stats:
        trees_close(tt.state.batch_stats, jt.state.batch_stats, "stats", rtol, atol)
    if jt.best_params is not None:
        trees_close(tt.best_params, jt.best_params, "best params", rtol, atol)
    assert tt.stopper.best_metric == pytest.approx(jt.stopper.best_metric, abs=1e-5)
    assert (tt.stopper.counter, tt.stopper.early_stop) == (jt.stopper.counter,
                                                           jt.stopper.early_stop)
    assert tt.np_rng.bit_generator.state == jt.np_rng.bit_generator.state


@pytest.mark.parametrize("on_device", [True, False])
@pytest.mark.parametrize("shuffle,max_steps", [(True, 0), (True, 2), (False, 0)])
def test_stack_split_matches_jax(tmp_path, shuffle, max_steps, on_device):
    """A 28-row split at batch 8 (4 batches, 4 pad rows) and a 3-row one
    (pad rows that wrap around twice): every column and weight bit-equal to
    JAX ``stack_batches`` (then cut at ``max_steps``), numpy ``stack_batches``
    too, and np_rng's state after."""
    jt, _, tt, _ = loop_pair(tmp_path, "mlp", n_per_domain=48, batch=8)
    tt._rows_on_device = on_device
    for split, jsplit in ((tt.dataset.train[0], jt.dataset.train[0]),
                          (tt.dataset.train[1].take(np.arange(3)),
                           jt.dataset.train[1].take(np.arange(3)))):
        want = jstack_batches(jsplit, 8, shuffle, np.random.default_rng(5))
        assert np.array_equal(stack_batches(split, 8, shuffle, np.random.default_rng(5))["pid"],
                              want["pid"])
        if max_steps:
            want = {k: v[:max_steps] for k, v in want.items()}
        tt.np_rng = np.random.default_rng(5)
        got = tt.stack_split(split, shuffle, max_steps)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert got[k].dtype == torch.from_numpy(v).dtype and got[k].is_contiguous(), k
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
        rng = np.random.default_rng(5)
        if shuffle:
            rng.permutation(split.n)
        assert tt.np_rng.bit_generator.state == rng.bit_generator.state
    # stack_train_epoch: the domain's train split, shuffled unless fixed_train
    jt.np_rng, tt.np_rng = np.random.default_rng(9), np.random.default_rng(9)
    for fixed in (False, True):
        jt.dataset.fixed_train = tt.dataset.fixed_train = fixed
        want = jax.device_get(jt.stack_train_epoch(2, max_steps=max_steps))
        got = tt.stack_train_epoch(2, max_steps=max_steps)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    assert tt.np_rng.bit_generator.state == jt.np_rng.bit_generator.state


@pytest.mark.parametrize("finetune", [False, True])
def test_fit_and_evaluate_domain_match_jax(tmp_path, finetune):
    """Three chained fit_domain calls (two domains, one capped at 2 steps),
    then evaluate_domain on the val and test splits: the loss within rtol
    2e-5, the confusion counts exact (threshold-edge rows set aside) and,
    with none set aside, the AUC within 1e-6."""
    jt, _, tt, _ = loop_pair(tmp_path, "mlp")
    jstate, tstate = jt.state, tt.state
    if finetune:  # from a fresh SGD state, as the finetune stage starts
        jstate = jstate.replace(opt_state=jt.finetune_fns.init_opt(jstate.params))
        tstate = tstate.replace(opt_state=tt.finetune_tx.init(tstate.params))
    for dom, cap in ((1, 0), (0, 2), (1, 0)):
        jstate, jloss = jt.fit_domain(jstate, dom, max_steps=cap, finetune=finetune)
        tstate, tloss = tt.fit_domain(tstate, dom, max_steps=cap, finetune=finetune)
        assert tloss.dim() == 0
        np.testing.assert_allclose(float(tloss), jloss, rtol=RTOL)
    jt.state, tt.state = jstate, tstate
    if finetune:
        assert int(tt.state.step) == int(jt.state.step) == 10
        trees_close(tt.state.params, jt.state.params, "params")
    else:
        states_close(jt, tt)
    loss_fn = jax.jit(jt.loss_fn, static_argnums=4)
    for mode in ("val", "test"):
        for dom in range(3):
            jl, ja = jt.evaluate_domain(mode, dom, jt.state.params, jt.state.batch_stats)
            tl, ta = tt.evaluate_domain(mode, dom, tt.state.params, tt.state.batch_stats)
            np.testing.assert_allclose(tl, jl, rtol=RTOL)
            stack = tt.eval_stack(mode, dom)
            jstack = jt.eval_stack(mode, dom)
            for k, v in jax.device_get(jstack).items():
                np.testing.assert_array_equal(stack[k].numpy(), np.asarray(v), err_msg=k)
            tprobs = torch.stack([tt.loss_fn(tt.state.params, {k: v[s] for k, v in
                                                               stack.items()}, probs=True)[2]
                                  for s in range(stack["weight"].shape[0])]).numpy()
            jprobs = np.stack([np.asarray(loss_fn(jt.state.params, jt.state.batch_stats,
                                                  {k: v[s] for k, v in jstack.items()},
                                                  jax.random.PRNGKey(0), False)[1][1])
                               for s in range(stack["weight"].shape[0])])
            w = stack["weight"].numpy()
            flips = counts_agree(tprobs[None], jprobs[None], stack["label"].numpy()[None],
                                 w[None])
            if not flips:
                assert ta == pytest.approx(ja, abs=1e-6)


MAMDR_LOOPS = {
    "plain": ("mlp_meta_mamdr_finetune", {}, False),
    "batch": ("mlp_meta_mamdr_batch_finetune", {}, False),
    "finetune_every_epoch": ("mlp_meta_mamdr_finetune", {"finetune_every_epoch": True},
                             False),
    "target": ("mlp_meta_mamdr_finetune", {"target_domain": 1}, False),
    "fixed_train": ("mlp_meta_mamdr_finetune", {"domain_regulation_step": 2}, True),
}


@pytest.mark.parametrize("variant", list(MAMDR_LOOPS))
def test_mamdr_loop_matches_jax(tmp_path, variant):
    """Two epochs of MAMDR's _train_loop (DN, DR with np_rng's support draws,
    the merged validation and best snapshot after each): params, Adam slots,
    shared, every specific, the best snapshot, early stop and np_rng."""
    name, train, fixed = MAMDR_LOOPS[variant]
    jt, js, tt, ts = loop_pair(tmp_path, name, fixed_train=fixed, **train)
    if variant == "plain":
        js.use_fused = ts.use_fused = False  # the shipped recipe, through the loop
    assert not ts.use_fused and not js.use_fused
    js.train()
    ts.train()
    states_close(jt, tt)
    trees_close(ts.shared, js.shared, "shared")
    trees_close(ts.best_shared, js.best_shared, "best shared")
    for d in range(3):
        for (n, m), a, b in zip(trees.leaves_with_names(ts.mask),
                                trees.leaves(ts.specific[d]),
                                jax.tree_util.tree_leaves(js.specific[d])):
            if m:
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL,
                                           err_msg=f"specific[{d}]:{n}")


def test_joint_loop_fixed_train_matches_jax(tmp_path):
    """joint's per-domain loop under fixed_train (no shuffle: the order is
    the split's), two epochs, then the test with the best weights."""
    jt, js, tt, ts = loop_pair(tmp_path, "mlp", fixed_train=True)
    assert type(ts) is JointStrategy and not tt.fused_padding_ok(ragged=True)
    js.train()
    ts.train()
    states_close(jt, tt)
    results_close(ts.test(), js.test())


@pytest.mark.parametrize("name", ["mlp_separate", "mlp_meta_mamdr_finetune"])
def test_separate_loop_matches_jax(tmp_path, name):
    """_separate_loop (separate_fused false): the separate strategy (every
    domain from the trainer's weights and optimizer state, Adam) and MAMDR's
    finetune stage (every domain from its merged best weights, fresh SGD):
    per-domain test loss and AUC, np_rng's state, and each domain_{d}.npz:
    every key the JAX package's file holds, frozen tables included, at
    RTOL / ATOL, and the JAX package's load_pytree reads it with a full
    template."""
    jt, js, tt, ts = loop_pair(tmp_path, name, separate_fused=False, epoch=3)
    if name == "mlp_separate":
        jres, tres = js.run(), ts.run()
    else:
        js.best_shared, ts.best_shared = js.shared, ts.shared
        jres, tres = js.finetune(), ts.finetune()
    results_close(tres, jres)
    assert tt.np_rng.bit_generator.state == jt.np_rng.bit_generator.state
    for d in range(3):
        with np.load(f"{tt.checkpoint_dir}/domain_{d}.npz") as z, \
                np.load(f"{jt.checkpoint_dir}/domain_{d}.npz") as jz:
            assert sorted(z.files) == sorted(jz.files)
            for k in z.files:
                assert z[k].shape == jz[k].shape, k
                np.testing.assert_allclose(z[k], jz[k], rtol=RTOL, atol=ATOL, err_msg=k)
            # the JAX loader raises on a missing key or a shape that differs
            loaded = jload_pytree(f"{tt.checkpoint_dir}/domain_{d}.npz", jt.state.params)
            for name, leaf in zip(trees.param_names(jax.device_get(loaded)),
                                  jax.tree_util.tree_leaves(loaded)):
                assert np.array_equal(np.asarray(leaf), z[name.replace("/", "//")]), name


ROUTES = [
    ("mlp", {}, JointStrategy),
    ("mlp_meta_domain_negotiation_finetune", {}, DomainNegotiationStrategy),
    ("mlp_meta_reptile_finetune", {}, ReptileStrategy),
    ("mlp_meta_maml_finetune", {}, MAMLStrategy),
    ("mlp_meta_maml_finetune", {"average_meta_grad": "drop"}, MAMLStrategy),
    ("mlp_pcgrad", {}, PCGradStrategy),
    ("mlp_meta_mamdr_finetune", {}, MAMDRStrategy),
    ("mlp_meta_mamdr_batch_finetune", {}, MAMDRStrategy),
]


@pytest.mark.parametrize("name,train,cls", ROUTES)
def test_loop_routes(tmp_path, monkeypatch, name, train, cls):
    """Each strategy takes its fused passes when the gate allows and its
    per-call loop when ``fused_padding_ok`` says no (a fixed train order,
    a block past the budget); MAML's "drop" and MAMDR's batch update take
    the loop either way, and so does a target domain; the meta-finetune
    validation takes its lanes or its sequential route by the same gate."""
    tt = Trainer(ExperimentConfig.from_dict({
        "model": {"name": name, "user_dim": 4, "item_dim": 4, "domain_dim": 4,
                  "hidden_dim": [8], "dropout": 0.0},
        "train": {"checkpoint_path": str(tmp_path), **train},
        "dataset": {"name": "synthetic", "batch_size": 16}}),
        make_synthetic_dataset(n_domain=3, n_uid=10, n_pid=10, n_per_domain=64,
                               batch_size=16), device="cpu", verbose=False)
    always_loop = train.get("average_meta_grad") == "drop" or "batch" in name
    taken = []
    fit = tt.fit_domain
    monkeypatch.setattr(tt, "fit_domain", lambda *a, **k: taken.append("fit") or fit(*a, **k))
    for ok in (True, False):
        monkeypatch.setattr(tt, "fused_padding_ok", lambda ragged=False, ok=ok: ok)
        strat = build_strategy(tt)
        assert type(strat) is cls
        if cls is JointStrategy:  # its epoch: the fused pass, or fit_domain a domain
            tt.config.train.epoch = 1
            strat.train()
            taken.append("|")
            continue
        monkeypatch.setattr(strat, "_train_fused", lambda: taken.append("fused"))
        monkeypatch.setattr(strat, "_train_loop", lambda: taken.append("loop"))
        strat.train()
        if ok:
            strat.target_domain = 1
            if isinstance(strat, MAMDRStrategy):
                strat.use_fused = False  # decided at construction from the target
            strat.train()
            strat.target_domain = -1
    if cls is JointStrategy:
        assert taken == ["|", "fit", "fit", "fit", "|"]
        return
    assert taken == ["loop" if always_loop else "fused", "loop", "loop"]
    if cls is JointStrategy:
        return
    strat.tc.meta_finetune_step = 1
    monkeypatch.setattr(strat, "_meta_finetune_val_fused", lambda: taken.append("lanes"))
    for ok in (True, False):
        monkeypatch.setattr(tt, "fused_padding_ok", lambda ragged=False, ok=ok: ok)
        strat.validate()
    assert taken[-4:] == ["lanes", "fit", "fit", "fit"]  # then one fit_domain a domain


def test_separate_routes_loop_under_fixed_train(tmp_path, monkeypatch):
    """fused_padding_ok is False, ragged too, whenever the dataset (not the
    config) has fixed_train; separate_train_val_test then takes the loop."""
    _, _, tt, _ = loop_pair(tmp_path, "mlp_finetune", n_per_domain=48)
    assert tt.fused_padding_ok() and tt.fused_padding_ok(ragged=True)
    tt.config.dataset.fixed_train = True
    assert tt.fused_padding_ok(ragged=True)
    tt.dataset.fixed_train = True
    assert not tt.fused_padding_ok() and not tt.fused_padding_ok(ragged=True)
    taken = []
    monkeypatch.setattr(separate, "_separate_loop", lambda *a, **k: taken.append(a[1:]))
    separate.separate_train_val_test(tt, init_params=False, max_finetune_epochs=4)
    assert taken == [(False, None, 4)]
