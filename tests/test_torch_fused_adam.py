"""The train step's Adam, apply and all-pad gate as one call
(``FlatAdam.step``, ``ops/fused_adam_update.py``): what can be held without
a card.

- ``adam_plan`` (kernel K4's launch in plain Python): each leaf's slot
  offset in leaf order, the float4 path only where every address stays
  float4-aligned, the tiles and the grid, on the benchmark cell's MLP leaves
  and on misaligned leaf lists; the kernel's own walk of the grid (block ->
  lane, leaf, elements) covers every element of every lane once, also over
  several launches;
- the combined step's plain route equals ``update`` + ``apply_updates`` +
  the gate as the train step ran them, bit for bit: one tower and lanes,
  a lane whose batch is all padding, frozen tables, counts 1 and 160; the
  ops module's plain version (``adam_update_reference``, and the wrapper's
  CPU route) gives the same bits and launches nothing;
- whole train steps against the train step as it was written before K4
  (kept here), bit for bit: the MLP one tower and over lanes (the subset
  lane step, an all-pad lane), frozen tables, masked SGD, and STAR with its
  batch statistics;
- ``trace.counters()`` carries ``k4.launches``, which no CPU step moves.

The kernel itself runs only on the card (``tests/test_torch_kernels_gpu.py``).
"""

import numpy as np
import pytest
import torch

from mamdr_tpu_torch.config import ExperimentConfig
from mamdr_tpu_torch.data.synthetic import make_synthetic_dataset
from mamdr_tpu_torch.models.deepctr import MLP
from mamdr_tpu_torch.ops.fast_random import step_seeds
from mamdr_tpu_torch.ops.fused_adam_update import (
    K4_MAX_LEAVES,
    K4_TILE,
    adam_plan,
    adam_update_reference,
    fused_adam_update,
)
from mamdr_tpu_torch.train.flat_optimizer import FlatAdamState, apply_updates
from mamdr_tpu_torch.train.state import TrainState
from mamdr_tpu_torch.train.steps import (
    make_loss_grad,
    make_optimizer,
    make_subset_train_step,
    make_train_step,
)
from mamdr_tpu_torch.train.trainer import Trainer
from mamdr_tpu_torch.utils import trace, trees

# The benchmark cell's MLP (Amazon-13, trainable 100000 x 128 user and item
# tables, 13 domains, 384-256-128-64-1) in JAX leaf order
CELL_LEAVES = [
    ("model/dnn/Dense_0/Dense_0/bias", (256,)),
    ("model/dnn/Dense_0/Dense_0/kernel", (384, 256)),
    ("model/dnn/Dense_1/Dense_0/bias", (128,)),
    ("model/dnn/Dense_1/Dense_0/kernel", (256, 128)),
    ("model/dnn/Dense_2/Dense_0/bias", (64,)),
    ("model/dnn/Dense_2/Dense_0/kernel", (128, 64)),
    ("model/embedding/domain_emb", (13, 128)),
    ("model/embedding/item_emb", (100000, 128)),
    ("model/embedding/user_emb", (100000, 128)),
    ("model/logit/Dense_0/Dense_0/kernel", (64, 1)),
]


def _walk(plan):
    """The kernel's walk of each launch's grid, in Python: every block's
    (lane, leaf, first element, elements), as ``adam_update_kernel`` derives
    them from its block index and the descriptors."""
    out = []
    for launch in plan.launches:
        for b in range(launch.blocks):
            lane, t = divmod(b, launch.tiles)
            k = max(j for j, t0 in enumerate(launch.tile0) if t0 <= t)
            leaf = launch.leaves[k]
            e0 = (t - launch.tile0[k]) * K4_TILE
            numel = plan.offsets[leaf + 1] - plan.offsets[leaf] if leaf + 1 < len(
                plan.offsets) else plan.slots - plan.offsets[leaf]
            out.append((lane, leaf, e0, min(K4_TILE, numel - e0)))
    return out


def test_plan_on_the_cells_mlp_leaves():
    model = MLP(50, 60, 13, 8, 8, 8, (16, 8, 4), 0.0,
                generator=torch.Generator().manual_seed(0))
    names = trees.param_names({"model": model.param_tree()})
    assert names == [n for n, _ in CELL_LEAVES]  # the order the slots follow
    numels = [int(np.prod(s)) for _, s in CELL_LEAVES]
    for lanes, blocks in ((1, 6289), (6, 6 * 6289), (7, 7 * 6289)):
        plan = adam_plan(numels, lanes)
        assert plan.slots == 25_741_440
        assert plan.offsets == tuple(np.cumsum([0] + numels[:-1]).tolist())
        assert plan.offsets[7:9] == (141_376, 12_941_376)  # the item and user tables
        assert all(plan.vec)
        (launch,) = plan.launches
        assert launch.leaves == tuple(range(10)) and launch.tiles == 6289
        assert launch.tile0 == (0, 1, 25, 26, 34, 35, 37, 38, 3163, 6288)
        assert launch.blocks == blocks


@pytest.mark.parametrize("numels,aligned,vec", [
    ([1, 4096, 3, 8193, 4, 0, 12], None, [False] * 7),        # slots 12309: no lane aligned
    ([4, 2, 2, 8, 1, 3], None, [True, False, False, True, False, False]),
    ([4, 2, 2, 8, 1, 3], [True, True, True, False, True, True], [True] + [False] * 5),
    ([8, 4096 * 3 + 4, 4], None, [True, True, True]),
])
def test_plan_on_misaligned_leaf_lists(numels, aligned, vec):
    plan = adam_plan(numels, 3, aligned)
    assert plan.slots == sum(numels)
    assert plan.offsets == tuple(np.cumsum([0] + numels[:-1]).tolist())
    assert list(plan.vec) == vec
    (launch,) = plan.launches
    assert launch.leaves == tuple(i for i, n in enumerate(numels) if n > 0)  # no empty leaf
    assert launch.tiles == sum(-(-n // K4_TILE) for n in numels)
    assert launch.blocks == 3 * launch.tiles


@pytest.mark.parametrize("numels,lanes", [
    ([256, 98304, 128, 32768, 1664, 4096 * 7 + 1, 64], 3),
    ([1, 4097, 3, 0, 8191, 2], 2),
    ([int(n) for n in np.random.default_rng(0).integers(0, 9000, K4_MAX_LEAVES * 2 + 5)], 2),
])
def test_plan_walk_covers_every_element_once(numels, lanes):
    plan = adam_plan(numels, lanes)
    assert all(len(launch.leaves) <= K4_MAX_LEAVES for launch in plan.launches)
    assert len(plan.launches) == -(-sum(n > 0 for n in numels) // K4_MAX_LEAVES)
    assert all(launch.tile0[0] == 0 for launch in plan.launches)
    seen = {}
    for lane, leaf, e0, count in _walk(plan):
        assert 0 < count <= K4_TILE and e0 % K4_TILE == 0
        for e in range(e0, e0 + count, 997):  # a sample of the block's elements
            key = (lane, leaf, e)
            assert key not in seen
            seen[key] = True
        assert e0 + count <= numels[leaf]
    covered = {(lane, leaf) for lane, leaf, _, _ in _walk(plan)}
    assert covered == {(l, i) for l in range(lanes) for i, n in enumerate(numels) if n > 0}
    for lane in range(lanes):
        for i, n in enumerate(numels):
            spans = sorted((e0, c) for l, leaf, e0, c in _walk(plan) if (l, leaf) == (lane, i))
            assert sum(c for _, c in spans) == n
            assert all(a[0] + a[1] == b[0] for a, b in zip(spans, spans[1:]))


def test_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="lane"):
        adam_plan([4], 0)
    with pytest.raises(ValueError, match="negative"):
        adam_plan([4, -1], 1)
    with pytest.raises(ValueError, match="flag"):
        adam_plan([4, 4], 1, [True])
    with pytest.raises(ValueError, match="grid"):
        adam_plan([K4_TILE * 2**12], 2**19)


def _tree(rng, lanes):
    lead = () if lanes is None else (lanes,)
    shapes = {"dnn": {"Dense_0": {"Dense_0": {"kernel": (6, 5), "bias": (5,)}}},
              "embedding": {"user_emb": (9, 4), "item_emb": (7, 4), "domain_emb": (3, 4)},
              "logit": {"Dense_0": {"Dense_0": {"kernel": (5, 1)}}}}
    return {"model": trees.tree_map(
        lambda s: torch.from_numpy(rng.normal(size=lead + s).astype(np.float32)), shapes)}


def _three_stages(tx, params, grads, state, has_data):
    """``update``, ``apply_updates`` and the gate as the train step ran them."""
    updates, new_opt = tx.update(grads, state)
    new_params = apply_updates(params, updates)

    def keep(new, old):
        if new is old:
            return old
        gate = has_data[(...,) + (None,) * (new.dim() - has_data.dim())]
        return torch.where(gate, new, old)

    return (trees.tree_map(keep, new_params, params),
            type(state)(*(keep(n, o) for n, o in zip(new_opt, state))))


@pytest.mark.parametrize("count", [0, 159])
@pytest.mark.parametrize("emb_trainable", [True, False])
@pytest.mark.parametrize("lanes", [None, 3])
def test_combined_step_equals_the_three_stages(lanes, emb_trainable, count):
    rng = np.random.default_rng(count + (lanes or 0))
    params = _tree(rng, lanes)
    tx = make_optimizer("adam", 1e-3, _tree(rng, None), emb_trainable)
    frozen = ("user_emb", "item_emb")
    if not emb_trainable and lanes is not None:  # frozen tables: one copy, no lane axis
        params = trees.named_tree_map(
            lambda n, x: x[0] if n.endswith(frozen) else x, params)
    n = sum(x[(0,) * (lanes is not None)].numel() for m, x in
            zip(trees.leaves(tx.mask), trees.leaves(params)) if m)
    lead = () if lanes is None else (lanes,)
    state = FlatAdamState(
        count=torch.full(lead, count, dtype=torch.int32),
        mu=torch.from_numpy(rng.normal(0, 1e-2, lead + (n,)).astype(np.float32)),
        nu=torch.from_numpy(rng.uniform(0, 1e-3, lead + (n,)).astype(np.float32)))
    grads = trees.named_tree_map(
        lambda name, m, x: torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
        if m else None, tx.mask, params)
    has_data = torch.tensor(True) if lanes is None else torch.tensor([True, False, True])
    want_p, want_s = _three_stages(tx, params, grads, state, has_data)
    got_p, got_s = tx.step(params, grads, state, has_data)
    for (name, a), b, m, old in zip(trees.leaves_with_names(got_p), trees.leaves(want_p),
                                    trees.leaves(tx.mask), trees.leaves(params)):
        assert torch.equal(a, b), name
        if not m:
            assert a is old  # a frozen leaf is the same tensor
        elif lanes is not None:  # the all-pad lane kept its leaf, the others moved
            assert torch.equal(a[1], old[1]) and not torch.equal(a[0], old[0])
    assert all(torch.equal(a, b) for a, b in zip(got_s, want_s))
    assert got_s.count.tolist() == ([count + 1, count, count + 1] if lanes else count + 1)

    # the ops module's plain version, and the wrapper's CPU route, give the same bits
    sel = [x for m, x in zip(trees.leaves(tx.mask), trees.leaves(params)) if m]
    gsel = [x for m, x in zip(trees.leaves(tx.mask), trees.leaves(grads)) if m]
    c = (state.count + 1).to(torch.float32).reshape(*lead, 1)
    bc1, bc2 = 1.0 - tx.b1 ** c, 1.0 - tx.b2 ** c
    before = trace.counters()["k4.launches"]
    for fn in (adam_update_reference, fused_adam_update):
        outs, mu, nu = fn(sel, gsel, state.mu, state.nu, bc1, bc2, has_data,
                          tx.learning_rate, tx.b1, tx.b2, tx.eps)
        want_sel = [x for m, x in zip(trees.leaves(tx.mask), trees.leaves(want_p)) if m]
        assert all(torch.equal(a, b) for a, b in zip(outs, want_sel))
        assert torch.equal(mu, want_s.mu) and torch.equal(nu, want_s.nu)
    assert trace.counters()["k4.launches"] == before


def _old_train_step(model, tx, cfg, combine=None):
    """The train step as it was written before K4: the optimizer's
    ``update``, ``apply_updates``, then the gate of every carried tensor."""
    loss_grad = make_loss_grad(model, cfg)
    has_stats = model.has_batch_stats

    def train_step(state, batch):
        seeds = step_seeds(state.seed, state.step, model.n_dropout_sites)
        params = state.params if combine is None else combine(state.params)
        if has_stats:
            data_loss, grads, new_stats = loss_grad(params, batch, seeds, train=True,
                                                    stats=state.batch_stats)
        else:
            data_loss, grads = loss_grad(params, batch, seeds, train=True)
        updates, new_opt = tx.update(grads, state.opt_state)
        new_params = apply_updates(state.params, updates)
        has_data = torch.sum(batch["weight"], dim=-1) > 0.0

        def keep(new, old):
            if new is old:
                return old
            gate = has_data[(...,) + (None,) * (new.dim() - has_data.dim())]
            return torch.where(gate, new, old)

        return state.replace(
            params=trees.tree_map(keep, new_params, state.params),
            opt_state=type(state.opt_state)(
                *(keep(n, o) for n, o in zip(new_opt, state.opt_state))),
            batch_stats=(trees.tree_map(keep, new_stats, state.batch_stats)
                         if has_stats else state.batch_stats),
            step=state.step + has_data.to(state.step.dtype),
        ), data_loss

    return train_step


def _trainer(name, emb_trainable, optimizer="adam"):
    extra = ({"norm": "pn", "dense": "star", "auxiliary_net": True, "auxiliary_dim": 8}
             if name == "star" else {})
    cfg = ExperimentConfig.from_dict({
        "model": {"name": name, "user_dim": 8, "item_dim": 8, "domain_dim": 8,
                  "hidden_dim": [16, 8], "dropout": 0.5, **extra},
        "train": {"emb_trainable": emb_trainable, "learning_rate": 1e-2,
                  "optimizer": optimizer},
        "dataset": {"name": "synthetic", "batch_size": 32},
    })
    ds = make_synthetic_dataset(n_domain=3, n_uid=50, n_pid=60, n_per_domain=100, seed=21,
                                batch_size=32)
    return Trainer(cfg, ds, device="cpu", verbose=False)


def _batches(lanes, steps=4):
    rng = np.random.default_rng(5)
    shape = (32,) if lanes is None else (lanes, 32)
    out = []
    for s in range(steps):
        w = (rng.uniform(0, 1, shape) > 0.2).astype(np.float32)
        if s == 2:  # all padding: the whole batch, or lane 1's
            w[... if lanes is None else 1] = 0.0
        out.append({"uid": torch.from_numpy(rng.integers(0, 50, shape).astype(np.int32)),
                    "pid": torch.from_numpy(rng.integers(0, 60, shape).astype(np.int32)),
                    "domain": torch.full(shape, s % 3, dtype=torch.int32),
                    "label": torch.from_numpy(rng.integers(0, 2, shape).astype(np.float32)),
                    "weight": torch.from_numpy(w)})
    return out


def _same_state(a, b):
    assert torch.equal(a.step, b.step)
    for (name, x), y in zip(trees.leaves_with_names(a.params), trees.leaves(b.params)):
        assert torch.equal(x, y), name
    assert all(torch.equal(x, y) for x, y in zip(a.opt_state, b.opt_state))
    for x, y in zip(trees.leaves(a.batch_stats), trees.leaves(b.batch_stats)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("name,emb_trainable,optimizer", [
    ("mlp", True, "adam"), ("mlp", False, "adam"), ("mlp", True, "sgd"),
    ("star", False, "adam"), ("deepfm", False, "adam"),
])
def test_train_step_equals_the_step_before_k4(name, emb_trainable, optimizer):
    t = _trainer(name, emb_trainable, optimizer)
    new, old = (make_train_step(t.model, t.tx, t.step_cfg),
                _old_train_step(t.model, t.tx, t.step_cfg))
    a = b = t.state
    for batch in _batches(None):
        a, la = new(a, batch)
        b, lb = old(b, batch)
        assert torch.equal(la, lb)
        _same_state(a, b)
    assert int(a.step) == 3  # the all-pad batch moved nothing


@pytest.mark.parametrize("emb_trainable", [True, False])
def test_subset_lane_step_equals_the_step_before_k4(emb_trainable):
    """The DR lanes' step: lane-stacked trainable leaves, the slots and the
    step broadcast from one tower (views, as ``fused.make_lane_state``
    makes them), frozen tables shared, lane 1 all padding at step 2."""
    t = _trainer("mlp", emb_trainable)
    lanes = 3
    frozen = t.frozen_mask()
    step, to_sub, combine = make_subset_train_step(t.model, t.tx, t.step_cfg, frozen,
                                                   t.state.params)
    sub = to_sub(t.state.params)
    lane = lambda x: x.expand(lanes, *x.shape)  # noqa: E731
    state = TrainState(
        params=trees.tree_map(lambda x: x if x.dim() == 0 else lane(x).contiguous(), sub),
        opt_state=type(t.state.opt_state)(*(lane(x) for x in t.state.opt_state)),
        seed=torch.arange(lanes), step=lane(t.state.step))
    old = _old_train_step(t.model, t.tx, t.step_cfg, combine)
    a = b = state
    for batch in _batches(lanes):
        a, la = step(a, batch)
        b, lb = old(b, batch)
        assert torch.equal(la, lb)
        _same_state(a, b)
    assert a.step.tolist() == [4, 3, 4]


def test_counters_carry_k4_launches():
    before = trace.counters()
    assert "k4.launches" in before
    t = _trainer("mlp", True)
    step = make_train_step(t.model, t.tx, t.step_cfg)
    state = t.state
    for batch in _batches(None, 2):
        state, _ = step(state, batch)
    assert trace.since(before).get("k4.launches", 0) == 0  # no launch on the CPU
