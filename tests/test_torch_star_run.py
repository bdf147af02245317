"""STAR's training paths in the port vs the JAX package's, with the batch
statistics.

By the recipe of tests/test_torch_zoo_run.py (3 domains, the same data and
start parameters, one batch a domain, frozen and trainable tables, balanced
and long-tailed data) and tests/test_torch_dr_phase.py (``shuffle=False``):

- a whole joint ``star`` ``run()`` (PartitionedNorm and BatchNorm), as
  tests/test_e2e_joint.py runs the JAX one: the test loss and AUC, the early
  stop, and the end-of-training statistics;
- a DN + sequential-DR epoch of ``star_meta_mamdr`` (the corpus's
  ``meta_parms`` ["emb", "kernel_shared", "bias_shared"]) against JAX
  ``make_fused_mamdr``, params, ``specific`` stack and statistics, as
  tests/test_fused.py runs the JAX phases; ``dr_parallel`` "auto" takes the
  sequential phase on both sides and "on" raises;
- a whole ``star_meta_mamdr_finetune`` ``run()``: DN, sequential DR, the
  merged val and test with the trainer's current statistics, the best
  snapshot, and the SGD finetune lanes, each lane training and keeping its
  own statistics;
- the finetune lanes alone: each lane moves only its own domain's row of
  the stacked statistics, and the best statistics are selected with the
  best weights;
- the merged val and test reading the current statistics (perturbed, so a
  stale tree would show), against the JAX package's;
- two shuffled epochs of MAMDR's per-call ``_train_loop`` on STAR with SGD
  as the inner optimizer (tests/test_torch_loops.py ``loop_pair``): params,
  statistics, shared and specific within 1e-6, the early stop and
  ``np_rng``'s state equal.

Tolerances: test loss rtol 1e-4 and AUC abs 1e-5, as the other ``run()``
tests; phase states rtol 2e-5 / atol 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from mamdr_tpu.config import ExperimentConfig as JConfig
from mamdr_tpu.data.synthetic import make_synthetic_dataset as jax_make_synthetic
from mamdr_tpu.strategies import build_strategy as jbuild_strategy
from mamdr_tpu.train import fused as jfused
from mamdr_tpu.train.trainer import Trainer as JTrainer
from mamdr_tpu_torch.config import ExperimentConfig
from mamdr_tpu_torch.convert import (
    batch_stats_from_jax,
    params_from_jax,
    spec_stack_from_jax,
    specific_from_jax,
)
from mamdr_tpu_torch.data.synthetic import make_synthetic_dataset
from mamdr_tpu_torch.strategies import separate
from mamdr_tpu_torch.strategies.base import build_strategy
from mamdr_tpu_torch.strategies.joint import JointStrategy
from mamdr_tpu_torch.strategies.mamdr import MAMDRStrategy
from mamdr_tpu_torch.train import fused
from mamdr_tpu_torch.train.trainer import Trainer
from mamdr_tpu_torch.utils import trees
from test_torch_loops import loop_pair, states_close, trees_close
from test_torch_strategies import events, results_close

META_PARMS = ["emb", "kernel_shared", "bias_shared"]
SETTINGS = [(True, False), (False, True)]
ORDER = np.asarray([2, 0, 1], np.int32)
AUX = np.asarray([[0, 1, 2], [2, 1, 0], [0, 2, 1]], np.int32)  # [query position, K]


def star_model(name, norm="pn"):
    return {"name": name, "user_dim": 8, "item_dim": 8, "domain_dim": 8,
            "hidden_dim": [16, 8], "auxiliary_dim": 8, "norm": norm, "dense": "star",
            "auxiliary_net": False}


def star_pair(tmp_path, name, long_tail=False, emb_trainable=False, batch=64, norm="pn",
              n_per_domain=100, **train):
    """(JAX trainer, JAX strategy, port trainer, port strategy) for STAR
    model `name` on the same data, parameters, statistics and (MAMDR)
    specific weights."""
    def config(side):
        return {
            "model": star_model(name, norm),
            "train": {"load_pretrain_emb": True, "emb_trainable": emb_trainable,
                      "learning_rate": 1e-2, "meta_learning_rate": 0.1, "sample_num": 2,
                      "epoch": 3, "patience": 2, "meta_parms": META_PARMS,
                      "checkpoint_path": str(tmp_path / side / "ckpt"),
                      "result_save_path": str(tmp_path / side / "result"), **train},
            "dataset": {"name": "synthetic", "batch_size": batch, "seed": 21},
        }

    kw = dict(n_domain=3, n_uid=50, n_pid=60, n_per_domain=n_per_domain, seed=21,
              long_tail=long_tail, batch_size=batch)
    jds, tds = jax_make_synthetic(**kw), make_synthetic_dataset(**kw)
    for ds in (jds, tds):
        rng = np.random.default_rng(0)
        ds.user_emb = rng.normal(0, 0.1, (50, 8)).astype(np.float32)
        ds.item_emb = rng.normal(0, 0.1, (60, 8)).astype(np.float32)
    jt = JTrainer(JConfig.from_dict(config("jax")), jds, verbose=False)
    js = jbuild_strategy(jt)
    tt = Trainer(ExperimentConfig.from_dict(config("port")), tds, device="cpu", verbose=False)
    tt.state = tt.state.replace(params=params_from_jax(jax.device_get(jt.state.params)),
                                batch_stats=batch_stats_from_jax(
                                    jax.device_get(jt.state.batch_stats)))
    ts = build_strategy(tt)
    if isinstance(ts, MAMDRStrategy):
        ts.shared = tt.state.params
        ts.specific = specific_from_jax(jax.device_get(js.specific), ts.mask, ts.shared)
        ts.best_shared, ts.best_specific = ts.shared, list(ts.specific)
    return jt, js, tt, ts


def _close(a, b, what, rtol=2e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol,
                               err_msg=what)


def _trees_close(port_tree, jax_tree, what, **tol):
    named = dict(zip(trees.param_names(jax.device_get(jax_tree)),
                     jax.tree_util.tree_leaves(jax_tree)))
    assert trees.param_names(port_tree) == list(named), what
    for name, leaf in trees.leaves_with_names(port_tree):
        _close(leaf.numpy(), named[name], f"{what}:{name}", **tol)


def _run_and_compare(pair):
    jt, js, tt, ts = pair
    jres, tres = js.run(), ts.run()
    results_close(tres, jres)
    assert tt.stopper.best_metric == pytest.approx(jt.stopper.best_metric, abs=1e-5)
    assert (tt.stopper.counter, tt.stopper.early_stop) == (jt.stopper.counter,
                                                           jt.stopper.early_stop)
    assert tt.np_rng.bit_generator.state == jt.np_rng.bit_generator.state
    assert events(tt) == events(jt)
    return jres, tres


@pytest.mark.parametrize("long_tail,emb_trainable", SETTINGS)
@pytest.mark.parametrize("norm", ["pn", "bn"])
def test_joint_star_run_matches_jax(tmp_path, norm, long_tail, emb_trainable):
    pair = star_pair(tmp_path, "star", long_tail, emb_trainable, norm=norm)
    jt, _, tt, ts = pair
    assert type(ts) is JointStrategy and max(tt.steps_per_domain()) == 1
    stats0 = tt.state.batch_stats
    _run_and_compare(pair)
    # the statistics trained with the weights, and the test read them
    _trees_close(tt.state.batch_stats, jt.state.batch_stats, "stats", rtol=1e-4, atol=1e-5)
    assert all(not torch.equal(a, b) for a, b in zip(trees.leaves(tt.state.batch_stats),
                                                      trees.leaves(stats0)))


def _phases(t, s, reg_step=0):
    block, n_steps = t.train_block()
    dn, dr = (jfused if isinstance(t, JTrainer) else fused).make_fused_mamdr(
        t.train_step_fn(), s.mask, "plus", n_steps, t.dataset.batch_size, reg_step,
        shuffle=False, steps_list=t.steps_per_domain())
    return block, dn, dr


@pytest.mark.parametrize("long_tail,emb_trainable", SETTINGS)
def test_dn_and_sequential_dr_epoch_match_make_fused_mamdr(tmp_path, long_tail,
                                                           emb_trainable):
    """One DN + sequential-DR epoch with both sides' shuffles off, several
    batches a domain: the state's params, statistics and step, ``shared``
    and the specific stack. Only the meta leaves are written into
    ``specific[q]``; the uncovered trainable leaves and the statistics
    chain through every query.

    The inner optimizer is SGD here: PartitionedNorm normalises the domain
    table's columns of x, which are constant in a one-domain batch, so the
    gradients of that table and of those columns' gammas are float rounding
    noise (the norm's backward cancels them exactly in exact arithmetic).
    Adam divides each gradient by its own running size, which makes such
    noise steps of order lr on either side, and trajectories apart; SGD
    keeps them at the noise's size."""
    jt, js, tt, ts = star_pair(tmp_path, "star_meta_mamdr_finetune", long_tail,
                               emb_trainable, batch=32, n_per_domain=300,
                               optimizer="sgd", learning_rate=0.1)
    assert max(tt.steps_per_domain()) > 1
    jblock, jdn, jdr = _phases(jt, js)
    tblock, tdn, tdr = _phases(tt, ts)
    jstate, jshared, jlosses = jdn(jt.state, js.shared, jblock, ORDER,
                                   jax.random.PRNGKey(0), 0.1)
    tstate, tshared, tlosses = tdn(tt.state, ts.shared, tblock, ORDER, tt.gen, 0.1)
    _close(tlosses.numpy(), jlosses, "DN losses")
    _trees_close(tstate.batch_stats, jstate.batch_stats, "DN stats")
    jstack = jfused.stack_specific(js.specific, js.mask)
    tstack0 = spec_stack_from_jax(jax.device_get(jstack), ts.mask, tshared)
    jstate, jstack = jdr(jstate, jshared, jstack, jblock, ORDER, AUX,
                         jax.random.PRNGKey(0), 0.1)
    tstate, tstack = tdr(tstate, tshared, tstack0, tblock, ORDER, AUX, tt.gen, 0.1)
    assert int(tstate.step) == int(jstate.step)
    _trees_close(tstate.params, jstate.params, "params")
    _trees_close(tstate.batch_stats, jstate.batch_stats, "stats")
    _trees_close(tshared, jshared, "shared")
    _trees_close(tstack, jstack, "specific stack")
    for (n, m), a, b in zip(trees.leaves_with_names(ts.mask), trees.leaves(tstack),
                            trees.leaves(tstack0)):
        # only the meta leaves carry a domain axis and moved; every domain's stat row did
        assert (m and not torch.equal(a, b)) or (not m and a is b), n
    mm = tstate.batch_stats["partitioned_norm"]["moving_mean"]
    assert bool((mm != 0).all())


def test_star_mamdr_dr_gate(tmp_path):
    """"auto" takes the sequential DR on both sides (the statistics, and the
    specific kernels outside the meta mask); "on" raises on both; the DR
    lanes refuse a state with statistics."""
    jt, js, tt, ts = star_pair(tmp_path, "star_meta_mamdr_finetune")
    assert not js._dr_parallel_eligible() and not ts._dr_parallel_eligible()
    ts.prepare_fused()
    assert not ts.dr_lanes
    for side in ("jax", "port"):
        jt2, js2, tt2, ts2 = star_pair(tmp_path / side, "star_meta_mamdr_finetune",
                                       dr_parallel="on")
        s = js2 if side == "jax" else ts2
        with pytest.raises(ValueError, match="batch statistics"):
            s._dr_parallel_eligible()
    with pytest.raises(ValueError, match="batch statistics"):
        fused.make_fused_dr_parallel(None, None, None, ts.mask, "plus", 1, 64)(
            tt.state, ts.shared, None, tt.train_block()[0], ORDER, AUX, tt.gen, 0.1)


@pytest.mark.parametrize("long_tail,emb_trainable", SETTINGS)
def test_star_mamdr_finetune_run_matches_jax(tmp_path, long_tail, emb_trainable):
    """The inner optimizer is SGD, for the reason the DN + DR epoch test
    gives: with Adam both sides turn the domain columns' rounding-noise
    gradients into steps of order lr, and after three epochs of DN and DR
    their test losses stand about 0.4% apart (the joint runs, nine steps,
    stay within 1e-4 under Adam)."""
    pair = star_pair(tmp_path, "star_meta_mamdr_finetune", long_tail, emb_trainable,
                     optimizer="sgd", learning_rate=0.1)
    jt, js, tt, ts = pair
    assert type(ts) is MAMDRStrategy and max(tt.steps_per_domain()) == 1
    start = list(ts.specific)
    _run_and_compare(pair)
    assert not ts.dr_lanes
    _trees_close(tt.state.batch_stats, jt.state.batch_stats, "stats", rtol=1e-4, atol=1e-5)
    for d in range(3):  # every domain's specific meta leaves moved, and are finite
        moved = [not torch.equal(a, b) for m, a, b in zip(
            trees.leaves(ts.mask), trees.leaves(ts.specific[d]), trees.leaves(start[d])) if m]
        assert any(moved), d
        assert all(bool(torch.isfinite(x).all()) for x in trees.leaves(ts.specific[d]))


def _perturbed_stats(t, seed):
    """Moving means N(0, 0.3) and variances uniform(0.01, 0.1): far from the
    initial zeros and ones, so the normalised inputs change a lot."""
    rng = np.random.default_rng(seed)

    def draw(name, x):
        d = (rng.uniform(0.01, 0.1, tuple(x.shape)) if name.endswith("var")
             else rng.normal(0, 0.3, tuple(x.shape)))
        return torch.from_numpy(d.astype(np.float32))

    return trees.named_tree_map(draw, t.state.batch_stats)


def test_merged_val_and_test_read_the_current_stats(tmp_path):
    """MAMDR's merged val (``shared`` / ``specific``) and test (the best
    snapshot) with the trainer's current statistics, perturbed on both
    sides alike, against the JAX package's; a stale tree would not match."""
    jt, js, tt, ts = star_pair(tmp_path, "star_meta_mamdr_finetune", long_tail=True)
    stats = _perturbed_stats(tt, 3)
    tt.state = tt.state.replace(batch_stats=stats)
    jt.state = jt.state.replace(batch_stats=jax.tree_util.tree_map(
        lambda x: jax.numpy.asarray(x.numpy()), stats))
    for mode in ("val", "test"):
        jres = js.validate() if mode == "val" else js.test()
        tres = ts.validate() if mode == "val" else ts.test()
        results_close(tres, jres)
    stale = tt.state.replace(batch_stats=batch_stats_from_jax(
        jax.device_get(JTrainer(jt.config, jt.dataset, verbose=False).state.batch_stats)))
    fresh_loss = ts.validate()[0]
    tt.state = stale
    assert ts.validate()[0] != pytest.approx(fresh_loss, rel=1e-4)


def test_finetune_lanes_train_and_keep_their_own_stats(tmp_path):
    """The finetune lanes start from the trainer's statistics, lane l moves
    only row ids[l] of its PartitionedNorm statistics, and the best
    statistics are each lane's at its best epoch."""
    _, _, tt, ts = star_pair(tmp_path, "star_meta_mamdr_finetune", n_per_domain=300, batch=32)
    lanes = separate.make_lanes(tt, init_params=False, params_fn=ts._best_params_fn)
    start = lanes.states.batch_stats["partitioned_norm"]["moving_mean"]
    assert torch.equal(start[1], tt.state.batch_stats["partitioned_norm"]["moving_mean"])
    states, _ = lanes.epoch_all(lanes.states, lanes.block, tt.gen)
    now = states.batch_stats["partitioned_norm"]["moving_mean"]
    for lane, d in enumerate(lanes.ids):
        others = [r for r in range(3) if r != d]
        assert torch.equal(now[lane, others], start[lane, others])
        assert not torch.equal(now[lane, d], start[lane, d])
    improved = torch.tensor([True, False, True])
    best = lanes.select_best(lanes.states.batch_stats, states.batch_stats, improved)
    got = best["partitioned_norm"]["moving_var"]
    want = states.batch_stats["partitioned_norm"]["moving_var"]
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    assert torch.equal(got[1], lanes.states.batch_stats["partitioned_norm"]["moving_var"][1])
    # the test of the best weights reads the best statistics: other statistics, other losses
    loss_best, _ = lanes.eval_all(states.params, lanes.test_block, lanes.test_steps, best)
    loss_start, _ = lanes.eval_all(states.params, lanes.test_block, lanes.test_steps,
                                   lanes.states.batch_stats)
    assert not torch.equal(loss_best[0], loss_start[0])
    assert torch.equal(loss_best[1], loss_start[1])


OTHER_STRATEGIES = [
    ("star_separate", {}),
    ("star_finetune", {}),
    ("star_meta_domain_negotiation_finetune", {}),
    ("star_meta_reptile_finetune", {}),
    ("star_meta_maml_finetune", {"meta_split": "meta-train/val", "meta_split_ratio": 0.5}),
    ("star_meta_mldg_finetune", {"meta_split": "meta-train/val", "meta_split_ratio": 0.5}),
    ("star_pcgrad", {}),
]


@pytest.mark.parametrize("name,train", OTHER_STRATEGIES)
def test_other_strategies_run_star_like_jax(tmp_path, name, train):
    """Every other strategy whose path carries the statistics runs STAR as
    the JAX package does: separate and finetune lanes, DN and Reptile passes,
    MAML's inner steps and MLDG's and PCGrad's accumulators (the norms in
    eval mode there). The inner optimizer is SGD, for the reason the DN + DR
    epoch test gives; the meta optimizers stay Adam, on eval-mode gradients."""
    pair = star_pair(tmp_path, name, long_tail=True, optimizer="sgd", learning_rate=0.1,
                     **train)
    jt, _, tt, ts = pair
    stats0 = tt.state.batch_stats
    _run_and_compare(pair)
    _trees_close(tt.state.batch_stats, jt.state.batch_stats, "stats", rtol=1e-4, atol=1e-5)
    # the trainer's own statistics move where its model takes train steps:
    # not in separate (the lanes train copies), MLDG and PCGrad (accumulators)
    trained = not any(k in name for k in ("separate", "mldg", "pcgrad"))
    assert trained == any(not torch.equal(a, b) for a, b in zip(
        trees.leaves(tt.state.batch_stats), trees.leaves(stats0)))


def test_star_mamdr_loop_matches_jax(tmp_path):
    """MAMDR's loop on STAR (PartitionedNorm, StarFCN; the corpus's
    meta_parms) with SGD as the inner optimizer: the statistics chain
    through every fit_domain call; params, statistics, shared and specific
    within 1e-6."""
    star = {"hidden_dim": [16, 8], "auxiliary_dim": 8, "norm": "pn", "dense": "star",
            "auxiliary_net": False}
    jt, js, tt, ts = loop_pair(tmp_path, "star_meta_mamdr_finetune", model=star,
                               optimizer="sgd", learning_rate=0.1,
                               meta_parms=["emb", "kernel_shared", "bias_shared"])
    js.use_fused = ts.use_fused = False
    js.train()
    ts.train()
    states_close(jt, tt, rtol=1e-6, atol=1e-6)
    trees_close(ts.shared, js.shared, "shared", rtol=1e-6, atol=1e-6)
    for d in range(3):
        for (n, m), a, b in zip(trees.leaves_with_names(ts.mask), trees.leaves(ts.specific[d]),
                                jax.tree_util.tree_leaves(js.specific[d])):
            if m:
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6,
                                           err_msg=f"specific[{d}]:{n}")
