"""PLE's one-task path (``models/mtl.py``): with whole task leaves, the last
CGC level and the tower run for the batch's domain alone.

At a small size (4 domains, 2 task experts and 1 shared a domain, experts
[16, 8], towers [8], dropout 0.5 with the same seeds handed to both), for
one and two levels, through ``apply`` (one tower) and ``apply_lanes`` (three
lanes on distinct domains, each lane with its own leaves and seeds), against
the flax PLE of the JAX package:

- logits and every leaf's gradient at rtol 2e-5 / atol 1e-5;
- every other task's slice of the last level's task leaves and of the
  towers, and the last level's shared gate, get a gradient of exactly 0;
- the towers' dropout masks are task d's rows of the whole [T, B, units]
  hash masks, bit for bit;
- ``ple.expert_rows`` equals ``ple.expert_rows_used``.

A rank's slice of the task experts (two ranks a table group, one level; the
rank alone in one process, its copy and sum the identity) keeps computing
each of its tasks' last level: ``ple.expert_rows`` counts held·t + s a row,
and on a batch of a domain the rank holds its logits and gradients are the
flax PLE's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mamdr_tpu.ops.fast_random as jfast_random
from mamdr_tpu.config import ExperimentConfig as JConfig
from mamdr_tpu.models.zoo import build_model as jax_build_model
from mamdr_tpu.train.steps import StepConfig as JStepConfig
from mamdr_tpu.train.steps import make_loss_fn as jax_make_loss_fn
from mamdr_tpu.utils import trees as jtrees
from mamdr_tpu_torch.config import ExperimentConfig
from mamdr_tpu_torch.convert import params_to_numpy
from mamdr_tpu_torch.models import layers
from mamdr_tpu_torch.models.zoo import build_model
from mamdr_tpu_torch.ops.fast_random import dropout_mask
from mamdr_tpu_torch.train.steps import StepConfig, make_autograd_loss_grad
from mamdr_tpu_torch.utils import trace, trees

T, N_UID, N_PID, BATCH, DIM, RATE = 4, 40, 50, 24, 8, 0.5
TOWER = [8]
LANE_DOMAINS = (3, 0, 2)
SHARED = ("embedding/user_emb", "embedding/item_emb")  # frozen, read by every lane


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread: the ops are tiny."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(levels, expert_mesh=None):
    """(flax PLE, port PLE, the port's params, which both are given)."""
    d = {"model": {"name": "ple", "user_dim": DIM, "item_dim": DIM, "domain_dim": DIM,
                   "hidden_dim": [16, 8], "tower_hidden_dim": TOWER, "dropout": RATE,
                   "specific_expert_num": 2, "shared_expert_num": 1, "num_levels": levels},
         "train": {"load_pretrain_emb": True}, "dataset": {"name": "synthetic"}}
    rng = np.random.default_rng(levels)
    pu = rng.normal(0, 0.1, (N_UID, DIM)).astype(np.float32)
    pi = rng.normal(0, 0.1, (N_PID, DIM)).astype(np.float32)
    jmodel = jax_build_model(JConfig.from_dict(d), N_UID, N_PID, T, pu, pi)
    tmodel = build_model(ExperimentConfig.from_dict(d), N_UID, N_PID, T, pu, pi,
                         generator=torch.Generator().manual_seed(0), expert_mesh=expert_mesh)
    params = trees.tree_map(torch.clone, tmodel.param_tree())  # the flax tree's names
    g = torch.Generator().manual_seed(11)
    for n, x in trees.leaves_with_names(params):  # biases and the domain table off zero
        if "bias" in n or n == "embedding/domain_emb":
            x.copy_(torch.randn(x.shape, generator=g) * 0.1)
    return jmodel, tmodel, params


def _batch(dom, seed):
    rng = np.random.default_rng(seed)
    return {"uid": torch.from_numpy(rng.integers(0, N_UID, BATCH).astype(np.int32)),
            "pid": torch.from_numpy(rng.integers(0, N_PID, BATCH).astype(np.int32)),
            "domain": torch.full((BATCH,), dom, dtype=torch.int32),
            "label": torch.from_numpy(rng.integers(0, 2, BATCH).astype(np.float32)),
            "weight": torch.from_numpy((rng.random(BATCH) > 0.2).astype(np.float32))}


def _flax(jmodel, monkeypatch):
    """(params, batch, seeds) -> (logits, {name: gradient}) of the flax PLE
    on the port's ``params``, its dropout layers handed ``seeds`` in call
    order: one jitted program, the seeds its argument."""
    loss_fn = jax_make_loss_fn(jmodel, JStepConfig(emb_trainable=False, has_dropout=True))

    def both(jparams, jb, jseeds):
        handed = []

        def injected(key):
            handed.append(None)
            return jseeds[(len(handed) - 1) % jseeds.shape[0]]

        monkeypatch.setattr(jfast_random, "key_to_seed", injected)
        key = jax.random.PRNGKey(0)
        logits = jmodel.apply({"params": jparams}, jb["uid"], jb["pid"], jb["domain"],
                              train=True, rngs={"dropout": key})
        _, g = jax.value_and_grad(loss_fn, has_aux=True)({"model": jparams}, {}, jb, key, True)
        assert len(handed) == 2 * jseeds.shape[0]  # each pass's dropout layers, once each
        return logits, g

    program = jax.jit(both)

    def run(params, batch, seeds):
        jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
        logits, g = program(params_to_numpy(params), jb,
                            jnp.asarray(seeds.numpy().astype(np.uint32)))
        return np.asarray(logits), dict(zip(jtrees.param_names(g), jax.tree_util.tree_leaves(g)))

    return run


def _task_leaves(levels):
    """The leaves indexed by task whose other tasks' slices no logit reads."""
    last = levels - 1
    return [f"task_expert_kernel_{last}", f"task_expert_bias_{last}",
            f"task_gate_kernel_{last}", "towers/tower_kernel_0", "towers/tower_bias_0",
            "towers/tower_logit"]


def _check_grads(got, want, dom, levels):
    for n, g in got.items():
        if g is None:
            assert n.split("/", 1)[1] in SHARED, n
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(want[n]), rtol=2e-5, atol=1e-5,
                                   err_msg=n)
    for n in _task_leaves(levels):
        g = got[f"model/{n}"]
        others = torch.cat([g[:dom], g[dom + 1:]])
        assert torch.any(g[dom] != 0), n
        assert torch.equal(others, torch.zeros_like(others)), n
    sg = got[f"model/shared_gate_kernel_{levels - 1}"]
    assert torch.equal(sg, torch.zeros_like(sg))


def _rows_counted(run, rows, used):
    before = trace.counters()
    out = run()
    got = trace.since(before)
    assert got["ple.expert_rows"] == got["ple.expert_rows_used"] == rows * used
    return out


@pytest.mark.parametrize("form", ["apply", "lanes"])
@pytest.mark.parametrize("levels", [1, 2])
def test_one_task_path_matches_flax(levels, form, monkeypatch):
    jmodel, tmodel, params = _models(levels)
    used = (levels - 1) * (2 * T + 1) + 2 + 1  # every task of the levels before, one of the last
    seeds = torch.tensor(np.random.default_rng(7 + levels).integers(
        0, 2**32, tmodel.n_dropout_sites * len(LANE_DOMAINS)).reshape(len(LANE_DOMAINS), -1))
    loss_grad = make_autograd_loss_grad(tmodel, StepConfig(emb_trainable=False))
    flax = _flax(jmodel, monkeypatch)

    if form == "apply":
        dom, batch = 1, _batch(1, 40 + levels)
        masks = []

        def recorded(seed, rate, shape, device=None):
            masks.append((tuple(shape), dropout_mask(seed, rate, shape, device)))
            return masks[-1][1]

        monkeypatch.setattr(layers, "dropout_mask", recorded)
        logits = _rows_counted(lambda: tmodel.apply(
            params, batch["uid"], batch["pid"], batch["domain"], seeds[0]), BATCH, used)
        # the towers' masks: task dom's rows of the whole [T, B, units] ones
        assert [s for s, _ in masks] == [(1, BATCH, u) for u in TOWER]
        for li, (_, m) in enumerate(masks):
            assert torch.equal(m[0], dropout_mask(seeds[0, li], RATE, (T, BATCH, TOWER[li]))[dom])
        _, grads = loss_grad({"model": params}, batch, seeds[0], train=True)
        want_logits, want_grads = flax(params, batch, seeds[0])
        np.testing.assert_allclose(logits.detach().numpy(), want_logits, rtol=2e-5, atol=1e-5)
        _check_grads(dict(trees.leaves_with_names(grads)), want_grads, dom, levels)
        return

    lanes = len(LANE_DOMAINS)
    stacked = trees.named_tree_map(
        lambda n, x: x if n in SHARED else torch.stack(
            [x * (1.0 + 0.2 * lane) + 0.01 * lane for lane in range(lanes)]), params)
    per = [_batch(d, 50 + d) for d in LANE_DOMAINS]
    batch = {k: torch.stack([b[k] for b in per]) for k in per[0]}
    logits = _rows_counted(lambda: tmodel.apply_lanes(
        stacked, batch["uid"], batch["pid"], batch["domain"], seeds=seeds), lanes * BATCH, used)
    _, grads = loss_grad({"model": stacked}, batch, seeds, train=True)
    for lane, dom in enumerate(LANE_DOMAINS):
        mine = trees.named_tree_map(lambda n, x: x if n in SHARED else x[lane], stacked)
        want_logits, want_grads = flax(mine, per[lane], seeds[lane])
        np.testing.assert_allclose(logits[lane].detach().numpy(), want_logits, rtol=2e-5,
                                   atol=1e-5)
        _check_grads({n: None if g is None else g[lane]
                      for n, g in trees.leaves_with_names(grads)}, want_grads, dom, levels)


class _RankOfTwo:
    """One rank of a table group of two, alone in one process: its copy and
    sum are the identity. That is exact for one level on a batch of a domain
    whose task experts the rank holds, since the other rank's tasks feed no
    head the batch selects and the level's shared mix feeds nothing."""

    def __init__(self, index):
        self.table_index = index

    @staticmethod
    def table_copy(x):
        return x

    table_sum = table_copy


@pytest.mark.parametrize("rank", [0, 1])
def test_rank_slice_counts_its_experts_and_matches_flax(rank, monkeypatch):
    held = T // 2
    jmodel, tmodel, params = _models(1, expert_mesh=_RankOfTwo(rank))
    cut = slice(rank * held, (rank + 1) * held)
    mine = trees.named_tree_map(lambda n, x: x[cut] if n.startswith("task_expert_") else x,
                                params)
    dom = rank * held + 1
    batch = _batch(dom, 60 + rank)
    seeds = torch.tensor(np.random.default_rng(9 + rank).integers(
        0, 2**32, tmodel.n_dropout_sites))
    before = trace.counters()
    logits = tmodel.apply(mine, batch["uid"], batch["pid"], batch["domain"], seeds)
    got = trace.since(before)
    assert (got["ple.expert_rows"], got["ple.expert_rows_used"]) == (
        BATCH * (held * 2 + 1), BATCH * (2 + 1))
    _, grads = make_autograd_loss_grad(tmodel, StepConfig(emb_trainable=False))(
        {"model": mine}, batch, seeds, train=True)
    want_logits, want_grads = _flax(jmodel, monkeypatch)(params, batch, seeds)
    np.testing.assert_allclose(logits.detach().numpy(), want_logits, rtol=2e-5, atol=1e-5)
    for n, g in trees.leaves_with_names(grads):
        if g is None:
            assert n.split("/", 1)[1] in SHARED, n
            continue
        want = np.asarray(want_grads[n])
        if n.startswith("model/task_expert_"):
            want = want[cut]
        np.testing.assert_allclose(g.numpy(), want, rtol=2e-5, atol=1e-5, err_msg=n)
