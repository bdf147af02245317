"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test decides inside a fixture whether a card is present
and skips without one. This file imports no JAX, so it runs on a machine
that has only PyTorch (the repo's conftest imports JAX; skip it there):

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py

Matmuls of the plain versions run in full float32 (TF32 off). K1 is held to
its plain version by ``kernel_check.k1_vs_plain``: the plain version is
independent of the kernel, and rows holding a ReLU unit that the two put on
different sides of 0 (within rounding of 0, else it raises) are set aside.
"""

import numpy as np
import pytest
import torch

from mamdr_tpu_torch.config import ExperimentConfig
from mamdr_tpu_torch.data.synthetic import make_synthetic_dataset
from mamdr_tpu_torch.ops import _cuda
from mamdr_tpu_torch.ops import fused_mlp_step
from mamdr_tpu_torch.ops.embedding_lookup import (
    embedding_lookup,
    embedding_lookup_reference,
    field_plan,
    gather_fields,
    gather_fields_reference,
    gather_rows_pipelined,
    ring_plan,
    table_rows,
)
from mamdr_tpu_torch.ops.fused_mlp_step import (
    fused_tower_grad,
    fused_tower_grad_lanes,
    k1_cuda_launches,
    k1_launch_plan,
    tower_grad_reference,
    tower_grad_reference_lanes,
)
from mamdr_tpu_torch.ops.fused_adam_update import adam_update_reference, fused_adam_update
from mamdr_tpu_torch.strategies.mamdr import MAMDRStrategy
from mamdr_tpu_torch.train.flat_optimizer import FlatAdamState, apply_updates
from mamdr_tpu_torch.train.steps import make_optimizer
from mamdr_tpu_torch.train.trainer import Trainer
from mamdr_tpu_torch.utils import trees
from mamdr_tpu_torch.utils.kernel_check import k1_vs_plain

K1_REL_TOL = 1e-4  # of each output's largest magnitude: float32 sums over
                   # up to 1024 rows, taken in another order, of products that
                   # K1 forms as three TF32 terms (float32-accurate; one TF32
                   # term alone would miss this tolerance)
BENCH_DIMS = (384, 256, 128, 64)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _tower_inputs(dims, batch, case, device, seed=0):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    x = rng.normal(0, 0.1, (batch, dims[0])).astype(np.float32)
    label = rng.integers(0, 2, batch).astype(np.float32)
    weight = (rng.uniform(0, 1, batch) > 0.2).astype(np.float32)
    if case == "partial":
        weight[:] = 1.0
        weight[batch * 2 // 3 :] = 0.0
    elif case == "all_pad":
        weight[:] = 0.0
    dense = []
    for i in range(len(dims) - 1):
        lim = np.sqrt(6.0 / (dims[i] + dims[i + 1]))
        dense.append(rng.uniform(-lim, lim, (dims[i], dims[i + 1])).astype(np.float32))
        dense.append(rng.normal(0, 0.05, dims[i + 1]).astype(np.float32))
    dense.append(rng.normal(0, 0.2, (dims[-1], 1)).astype(np.float32))
    seeds = torch.tensor([0xDEADBEEF, 7, 2**31 + 5][: len(dims) - 1], dtype=torch.int64,
                         device=device)
    return t(x), t(label), t(weight), seeds, tuple(t(a) for a in dense)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("case", ["mixed", "partial", "all_pad"])
@pytest.mark.parametrize("dims,batch", [((384, 256, 128, 64), 1024), ((24, 32, 16), 37)])
def test_tower_kernel_matches_plain(cuda_device, rate, case, dims, batch):
    """K1 at the main path's shapes, and at a small ragged shape whose edges
    cut through every tile."""
    args = _tower_inputs(dims, batch, case, cuda_device)
    before = fused_tower_grad.launches
    r = k1_vs_plain(fused_tower_grad, tower_grad_reference, *args, dims, rate, K1_REL_TOL)
    assert fused_tower_grad.launches == before + 1 + bool(r["flips"])
    lk, dxk, gk = r["out"]
    assert len(gk) == 2 * (len(dims) - 1) + 1
    # no atomics: a second call gives the same bits
    lk2, dxk2, gk2 = fused_tower_grad(*args, dims, rate)
    for a, b in [(lk, lk2), (dxk, dxk2), *zip(gk, gk2)]:
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_gather_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(0)
    n, d, b = 100_000, 128, 1024
    table = torch.from_numpy(rng.normal(0, 1, (n, d)).astype(np.float32)).to(cuda_device)
    ids_np = rng.integers(0, n, b).astype(np.int32)
    ids_np[:4] = [-1, n, -(2**31), 2**31 - 1]
    ids = torch.from_numpy(ids_np).to(cuda_device)
    before = gather_fields.launches
    got = embedding_lookup(table, ids)  # K2's one-field case
    torch.cuda.synchronize()
    assert gather_fields.launches == before + 1
    assert torch.equal(got, embedding_lookup_reference(table, ids))  # a gather: exact
    with pytest.raises(ValueError):
        embedding_lookup(table, ids.long())  # the kernel takes int32 ids only
    with pytest.raises(ValueError):
        embedding_lookup(table[:, :6].contiguous(), ids)  # D % 4 != 0


@pytest.mark.gpu
def test_gather_kernel_at_the_lane_steps_shapes(cuda_device):
    """K2 with one field of 30 lanes x 1024 ids in one launch: the shared
    table, and a lane-stacked domain table with every lane's own
    out-of-range ids, against table_rows (the plain route through the
    [L*N, D] view) and against indexing each lane's table. Exact."""
    rng = np.random.default_rng(1)
    lanes, b, d = 30, 1024, 128
    for n, stacked in ((100_000, False), (30, True)):
        shape = (lanes, n, d) if stacked else (n, d)
        table = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(cuda_device)
        ids_np = rng.integers(0, n, (lanes, b)).astype(np.int32)
        ids_np[:, :5] = [-1, -(2**31), n, n + 1, 2**31 - 1]
        ids = torch.from_numpy(ids_np).to(cuda_device)
        before = gather_fields.launches
        rows, (flat,) = gather_fields((table,), (ids,), train_mask=(True,))
        assert gather_fields.launches == before + 1 and flat.numel() == lanes * b
        clipped = ids.long().clamp(0, n - 1)
        alone = (table[torch.arange(lanes, device=cuda_device)[:, None], clipped]
                 if stacked else table[clipped])
        assert torch.equal(rows, alone)
        plain, plain_flat = table_rows(table, ids)
        assert torch.equal(rows, plain) and torch.equal(flat, plain_flat)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("dims", [BENCH_DIMS, (24, 32, 16)])
@pytest.mark.parametrize("batch", [1, 32, 37, 1000, 1024])
@pytest.mark.parametrize("lanes", [1, 3, 5, 30])
def test_tower_kernel_lanes(cuda_device, rate, dims, batch, lanes):
    """K1 with a lane axis, over lane counts, batches (one row; no multiple of
    a slab; the main path's) and dims (the main path's; narrow ones that cut
    through every tile): against the lane-batched plain version (a partial
    and an all-pad lane in the call), lane l bit-equal to the single-lane
    call, the same bits from a second call, at most 4 CUDA launches a call."""
    per = [_tower_inputs(dims, batch, {1: "partial", 2: "all_pad"}.get(l, "mixed"),
                         cuda_device, seed=l) for l in range(lanes)]
    x, label, weight = (torch.stack([p[i] for p in per]) for i in range(3))
    dense = tuple(torch.stack([p[4][i] for p in per]) for i in range(len(per[0][4])))
    seeds = torch.stack([p[3] + 1000 * l for l, p in enumerate(per)])
    before = fused_tower_grad_lanes.launches
    r = k1_vs_plain(fused_tower_grad_lanes, tower_grad_reference_lanes,
                    x, label, weight, seeds, dense, dims, rate, K1_REL_TOL)
    assert fused_tower_grad_lanes.launches == before + 1 + bool(r["flips"])
    lk, dxk, gk = r["out"]
    if lanes > 2:
        assert float(lk[2]) == 0.0 and not bool(dxk[2].any())
        assert not any(bool(g[2].any()) for g in gk)
    for l in range(lanes):
        l1, dx1, g1 = fused_tower_grad(x[l], label[l], weight[l], seeds[l],
                                       tuple(t[l] for t in dense), dims, rate)
        assert torch.equal(l1, lk[l]) and torch.equal(dx1, dxk[l])
        assert all(torch.equal(a, b[l]) for a, b in zip(g1, gk))
    issued = k1_cuda_launches()
    lk2, dxk2, gk2 = fused_tower_grad_lanes(x, label, weight, seeds, dense, dims, rate)
    assert 1 <= k1_cuda_launches() - issued <= 4
    assert torch.equal(lk, lk2) and torch.equal(dxk, dxk2)
    assert all(torch.equal(a, b) for a, b in zip(gk, gk2))


@pytest.mark.gpu
@pytest.mark.parametrize("dims,batch,lanes", [(BENCH_DIMS, 1024, 1), (BENCH_DIMS, 1024, 30),
                                              ((24, 32, 16), 32, 1), (BENCH_DIMS, 1000, 3),
                                              ((1024, 1024, 64), 100, 2)])
def test_tower_launch_plan_matches_the_library(cuda_device, dims, batch, lanes):
    """The Python plan and csrc/fused_mlp_step.cu lay out the same workspace
    and the same shared memory, and a call issues the plan's launches."""
    import ctypes

    _, scratch, shared, _ = fused_mlp_step._bind()
    plan = k1_launch_plan(dims, batch, lanes, _cuda.sm_count(cuda_device))
    dims_c = (ctypes.c_int * len(dims))(*dims)
    assert scratch(len(dims) - 1, dims_c, batch) * lanes == plan.workspace_floats
    assert shared(len(dims) - 1, dims_c, plan.slab_rows) == plan.shared_bytes
    assert plan.shared_bytes <= 232448 and plan.launches <= 4
    per = [_tower_inputs(dims, batch, "mixed", cuda_device, seed=l) for l in range(lanes)]
    x, label, weight, seeds = (torch.stack([p[i] for p in per]) for i in range(4))
    dense = tuple(torch.stack([p[4][i] for p in per]) for i in range(len(per[0][4])))
    issued = k1_cuda_launches()
    fused_tower_grad_lanes(x, label, weight, seeds, dense, dims, 0.5)
    torch.cuda.synchronize()
    assert k1_cuda_launches() - issued == plan.launches


@pytest.mark.gpu
def test_tower_entry_refuses_a_short_workspace(cuda_device, monkeypatch):
    """The C entry is told the workspace's length and refuses one shorter than
    its own layout needs, instead of writing past it."""
    dims, batch = (24, 32, 16), 32
    args = _tower_inputs(dims, batch, "mixed", cuda_device)
    fused_tower_grad(*args, dims, 0.5)
    full = fused_mlp_step._workspace(args[0].device, 1, batch, dims)
    assert full.numel() == k1_launch_plan(dims, batch, 1).workspace_floats
    monkeypatch.setattr(fused_mlp_step, "_workspace", lambda *a: full[:-4])
    with pytest.raises(RuntimeError, match="CUDA error"):
        fused_tower_grad(*args, dims, 0.5)


@pytest.mark.gpu
def test_tower_workspaces_are_bounded_and_never_made_under_capture(cuda_device):
    """Only the shapes used last keep a workspace, the same tensor serves a
    shape's later calls, and a shape's first call inside a CUDA-graph capture
    raises (the graph's private pool would own the tensor)."""
    dims = (24, 32, 16)
    kept = fused_mlp_step._workspace.kept
    for batch in range(1, fused_mlp_step.WORKSPACES_KEPT + 3):
        fused_tower_grad(*_tower_inputs(dims, batch, "mixed", cuda_device), dims, 0.5)
    assert len(kept) == fused_mlp_step.WORKSPACES_KEPT
    assert all(key[2] > 2 for key in kept)  # (device, lanes, batch, dims): 1 and 2 went
    args = _tower_inputs(dims, batch, "mixed", cuda_device)
    before = fused_mlp_step._workspace(args[0].device, 1, batch, dims)
    fused_tower_grad(*args, dims, 0.5)
    assert fused_mlp_step._workspace(args[0].device, 1, batch, dims) is before
    torch.cuda.synchronize()
    new = _tower_inputs(dims, 99, "mixed", cuda_device)
    with torch.cuda.graph(torch.cuda.CUDAGraph()):
        with pytest.raises(RuntimeError, match="capture"):
            fused_tower_grad(*new, dims, 0.5)
        fused_tower_grad(*args, dims, 0.5)  # a shape already seen captures


@pytest.mark.gpu
def test_tower_slab_rows_change_no_bit(cuda_device, monkeypatch):
    """16-, 32- and 64-row slabs give the same bits, which is what lets the
    plan pick the slab by how full the card is and lane l still equal the
    single-lane call."""
    args = _tower_inputs(BENCH_DIMS, 1024, "mixed", cuda_device)
    plan = fused_mlp_step.k1_launch_plan
    outs = {}
    for rows in (16, 32, 64):
        monkeypatch.setattr(
            fused_mlp_step, "k1_launch_plan",
            lambda d, b, l, sms=132, rows=rows: plan(d, b, l, sms)._replace(
                slab_rows=rows, slabs=-(-b // rows)))
        loss, dx, grads = fused_tower_grad(*args, BENCH_DIMS, 0.5)
        outs[rows] = [loss, dx, *grads]
    for rows in (32, 64):
        assert all(torch.equal(a, b) for a, b in zip(outs[16], outs[rows]))


def _field_inputs(lanes, b, widths, stacked, device, seed=0, n_rows=(100_000, 100_000, 30)):
    """Tables and int32 ids of a field gather; every lane has ids below 0 and
    past its own table (for a lane-stacked table: past the lane's rows)."""
    rng = np.random.default_rng(seed)
    tables, ids = [], []
    for f, (d, st) in enumerate(zip(widths, stacked)):
        n = n_rows[f % len(n_rows)]
        shape = (lanes, n, d) if st else (n, d)
        tables.append(torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(device))
        i = rng.integers(0, n, (lanes, b)).astype(np.int32)
        i[:, : min(b, 5)] = [-1, -(2**31), n, n + 5, 2**31 - 1][: min(b, 5)]
        ids.append(torch.from_numpy(i if lanes > 1 else i[0]).to(device))
    return tables, ids


FIELD_CASES = [  # (widths, lane-stacked per field)
    ((128, 128, 128), (False, False, True)),  # the main path's fields
    ((16, 24, 32), (True, False, True)),       # mixed widths
    ((128,), (True,)),
    ((24,), (False,)),
]


@pytest.mark.gpu
@pytest.mark.parametrize("fields", range(len(FIELD_CASES)))
@pytest.mark.parametrize("lanes,b", [(1, 1), (1, 37), (1, 1024), (1, 30720),
                                     (30, 1), (30, 37), (30, 1024)])
def test_field_gather_kernel_matches_plain(cuda_device, lanes, b, fields):
    """K2: every field's rows into one output in one launch, exact against
    the plain version (table_rows of each field and torch.cat), ids out of
    range in every lane; and the flat row ids it writes for the marked
    fields, equal to table_rows'."""
    widths, stacked = FIELD_CASES[fields]
    if lanes == 1:
        stacked = (False,) * len(widths)
    tables, ids = _field_inputs(lanes, b, widths, stacked, cuda_device, seed=b + lanes)
    mask = tuple(f % 2 == 0 for f in range(len(widths)))
    before = gather_fields.launches
    x, flats = gather_fields(tables, ids, train_mask=mask)
    torch.cuda.synchronize()
    assert gather_fields.launches == before + 1
    want, want_flats = gather_fields_reference(tables, ids, train_mask=mask)
    assert x.shape == (*ids[0].shape, sum(widths)) and torch.equal(x, want)
    for got, exp in zip(flats, want_flats):
        assert (got is None) == (exp is None)
        if got is not None:
            assert got.dtype == torch.int32 and torch.equal(got, exp)


@pytest.mark.gpu
def test_field_gather_kernel_in_a_cuda_graph(cuda_device):
    """One K2 call captured in a CUDA graph and replayed on new ids (the
    descriptors travel by value: nothing is copied or allocated per call)
    equals an eager call on those ids."""
    tables, ids = _field_inputs(30, 1024, (128, 128, 128), (False, False, True), cuda_device)
    static = [i.clone() for i in ids]
    gather_fields(tables, static, train_mask=(False, False, True))  # warm-up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        x, flats = gather_fields(tables, static, train_mask=(False, False, True))
    _, new = _field_inputs(30, 1024, (128, 128, 128), (False, False, True), cuda_device, seed=9)
    for s_, n_ in zip(static, new):
        s_.copy_(n_)
    graph.replay()
    torch.cuda.synchronize()
    want, want_flats = gather_fields(tables, new, train_mask=(False, False, True))
    assert torch.equal(x, want) and torch.equal(flats[2], want_flats[2])


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [1, 3])
def test_field_gather_backward_on_the_card_equals_the_cpu(cuda_device, lanes):
    """The autograd rule: the scatter-add of each trainable field's column
    slice of dx at the clamped row ids, on the card, against the plain
    version's gradient on the CPU (index_add_ sums rows in another order:
    float32 rounding only)."""
    widths, stacked = (16, 24, 32), (False, False, lanes > 1)
    tables, ids = _field_inputs(lanes, 64, widths, stacked, cuda_device, seed=lanes,
                                n_rows=(50, 60, 4))
    c = torch.from_numpy(np.random.default_rng(2).normal(
        0, 1, (*ids[0].shape, sum(widths))).astype(np.float32))
    grads = {}
    for where in ("cuda", "cpu"):
        tt = [t.detach().to(where).requires_grad_(f != 1) for f, t in enumerate(tables)]
        before = gather_fields.launches
        x, _ = gather_fields(tt, [i.to(where) for i in ids])
        (x * c.to(where)).sum().backward()
        assert gather_fields.launches == before + (where == "cuda")
        assert tt[1].grad is None
        grads[where] = [tt[0].grad.cpu(), tt[2].grad.cpu()]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("lanes,b,stacked", [(1, 1024, False), (30, 1024, False),
                                             (3, 37, True)])
@pytest.mark.parametrize("table_index", [0, 1])
def test_field_gather_row_window_matches_plain(cuda_device, lanes, b, stacked, table_index):
    """K2 with row windows (the row-sharded lookup of a (., 2) mesh): the
    user and item fields as shard ``table_index`` of a table twice their
    rows (WINDOW: zeros outside, the spare row as their row id), the domain
    field read with the clamp by table index 0 and SILENT by the other
    (zeros, the clamped row ids); ids inside, outside and past int32 in
    every lane. Exact against the plain version, x and row ids, the
    windowed launch counted; the two shards' x summed equal the unsharded
    gather; the backward's scatter drops the spare row, as on the CPU
    (``index_add_`` sums a row's terms in another order: float32 rounding,
    held to 1e-6 of the gradient's largest value)."""
    from mamdr_tpu_torch.ops.embedding_lookup import CLAMP, SILENT, WINDOW

    n = (300, 400, 4)
    tables, ids = _field_inputs(lanes, b, (128, 128, 128), (stacked, False, lanes > 1),
                                cuda_device, seed=lanes + table_index, n_rows=n)
    whole = [torch.cat([t, t.flip(-2)], dim=-2) if f < 2 else t
             for f, t in enumerate(tables)]  # shard 0: rows [0, n), shard 1: [n, 2n)
    ids = [i.clamp(-4, 2 * n[f] + 3) if f < 2 else i for f, i in enumerate(ids)]
    xs = []
    for ti in (0, 1):
        shards = [w.narrow(-2, ti * n[f], n[f]).contiguous() if f < 2 else w
                  for f, w in enumerate(whole)]
        win = ((ti * n[0], WINDOW), (ti * n[1], WINDOW), (0, CLAMP if ti == 0 else SILENT))
        before = (gather_fields.launches, gather_fields.window_launches)
        x, flats = gather_fields(shards, ids, train_mask=(True, True, True), windows=win)
        torch.cuda.synchronize()
        assert (gather_fields.launches, gather_fields.window_launches) == (
            before[0] + 1, before[1] + 1)
        want, want_flats = gather_fields_reference(shards, ids, (True, True, True), win)
        assert torch.equal(x, want)
        assert all(torch.equal(a, e) for a, e in zip(flats, want_flats))
        xs.append(x)
        if ti == table_index:
            c = torch.randn(x.shape, generator=torch.Generator().manual_seed(3))
            grads = {}
            for where in ("cuda", "cpu"):
                tt = [t.detach().to(where).requires_grad_(True) for t in shards]
                xw, _ = gather_fields(tt, [i.to(where) for i in ids], windows=win)
                (xw * c.to(where)).sum().backward()
                grads[where] = [t.grad.cpu() for t in tt]
            for a, e in zip(grads["cuda"], grads["cpu"]):
                torch.testing.assert_close(a, e, rtol=1e-5, atol=1e-6 * float(e.abs().max()))
    full, _ = gather_fields_reference(
        whole, [torch.where((i >= 0) & (i < 2 * n[f]), i, 0) if f < 2 else i
                for f, i in enumerate(ids)])
    inside = [((i >= 0) & (i < 2 * n[f]))[..., None] for f, i in enumerate(ids[:2])]
    full = torch.cat([torch.where(inside[0], full[..., :128], 0.0),
                      torch.where(inside[1], full[..., 128:256], 0.0), full[..., 256:]], -1)
    assert torch.equal(xs[0] + xs[1], full)


@pytest.mark.gpu
def test_field_gather_default_window_is_the_clamp(cuda_device):
    """No window and an explicit clamp window are the same launch, bit for
    bit, with the same row ids, and are not counted as windowed."""
    from mamdr_tpu_torch.ops.embedding_lookup import CLAMP

    tables, ids = _field_inputs(30, 1024, (128, 128, 128), (False, False, True), cuda_device)
    before = gather_fields.window_launches
    x0, f0 = gather_fields(tables, ids, train_mask=(False, False, True))
    x1, f1 = gather_fields(tables, ids, train_mask=(False, False, True),
                           windows=((0, CLAMP),) * 3)
    torch.cuda.synchronize()
    assert gather_fields.window_launches == before
    assert torch.equal(x0, x1) and torch.equal(f0[2], f1[2])


@pytest.mark.gpu
def test_model_loss_gives_the_tables_a_gradient_on_the_card(cuda_device):
    """MLP.forward through make_loss_fn on the card: autograd gives every
    table that trains (the domain table above all) the gradient it has on
    the CPU — the K2 wrapper is differentiable, not a bare kernel output."""
    from mamdr_tpu_torch.models.zoo import build_model
    from mamdr_tpu_torch.train.steps import StepConfig, make_loss_fn

    cfg = ExperimentConfig.from_dict({
        "model": {"name": "mlp", "user_dim": 8, "item_dim": 8, "domain_dim": 8,
                  "hidden_dim": [16, 8], "dropout": 0.0},
        "dataset": {"name": "synthetic"}})
    model = build_model(cfg, 20, 30, 4, generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    batch = {"uid": rng.integers(-2, 22, 64).astype(np.int32),
             "pid": rng.integers(0, 30, 64).astype(np.int32),
             "domain": rng.integers(-1, 5, 64).astype(np.int32),
             "label": rng.integers(0, 2, 64).astype(np.float32),
             "weight": np.ones(64, np.float32)}
    grads = {}
    for where in ("cuda", "cpu"):
        params = trees.tree_map(lambda t: t.detach().clone().to(where).requires_grad_(True),
                                model.param_tree())
        loss, _ = make_loss_fn(model, StepConfig())(
            {"model": params}, {k: torch.from_numpy(v).to(where) for k, v in batch.items()})
        loss.backward()
        grads[where] = {n: p.grad for n, p in trees.leaves_with_names(params)}
    assert bool(grads["cuda"]["embedding/domain_emb"].abs().sum() > 0)
    for name, g in grads["cpu"].items():
        torch.testing.assert_close(grads["cuda"][name].cpu(), g, rtol=1e-4, atol=1e-6,
                                   msg=name)


@pytest.mark.gpu
def test_field_gather_refuses_what_the_kernel_does_not_take(cuda_device, monkeypatch):
    tables, ids = _field_inputs(1, 8, (8, 8, 8, 8, 8), (False,) * 5, cuda_device,
                                n_rows=(10,))
    with pytest.raises(ValueError, match="1 to 4 fields"):
        gather_fields(tables, ids)
    with pytest.raises(ValueError, match="one shape"):
        gather_fields(tables[:2], [ids[0], ids[1][:4]])
    with pytest.raises(ValueError, match="CUDA"):
        gather_fields(tables[:2], [ids[0], ids[1].cpu()])
    with pytest.raises(ValueError, match="D % 4"):
        gather_fields([tables[0][:, :6].contiguous()], ids[:1])
    with pytest.raises(ValueError, match="lane-stacked"):
        gather_fields([tables[0][None].contiguous()], ids[:1])
    assert field_plan([t.shape for t in tables[:4]], (8,)).blocks == 2
    # the kernel runs on field_plan's grid: the C entry refuses one that
    # leaves a row without a warp or a block past its 128 threads
    from mamdr_tpu_torch.ops import embedding_lookup as k2
    tables, ids = _field_inputs(1, 37, (8, 16), (False, False), cuda_device)
    want = gather_fields_reference(tables, ids)[0]
    plan = k2.field_plan([t.shape for t in tables], (37,))
    for blocks, threads in ((37, 32), (5, 128), (plan.blocks - 1, 128), (2, 160)):
        monkeypatch.setattr(k2, "field_plan", lambda *a, b=blocks, t=threads:
                            plan._replace(blocks=b, threads=t))
        if blocks * threads // 32 >= 37 and threads <= 128:
            assert torch.equal(gather_fields(tables, ids)[0], want), (blocks, threads)
        else:
            with pytest.raises(RuntimeError, match="gather_fields: CUDA error"):
                gather_fields(tables, ids)


@pytest.mark.gpu
def test_ring_gather_kernel(cuda_device):
    """K3 exact against K2 and the plain version for k 32 and 128 (and odd
    depths and sizes); its grid covers the card; a ring that does not fit
    shared memory raises."""
    rng = np.random.default_rng(0)
    n, d, b = 100_000, 128, 1024
    table = torch.from_numpy(rng.normal(0, 1, (n, d)).astype(np.float32)).to(cuda_device)
    ids_np = rng.integers(0, n, b).astype(np.int32)
    ids_np[:4] = [-1, n, -(2**31), 2**31 - 1]
    ids = torch.from_numpy(ids_np).to(cuda_device)
    want = embedding_lookup(table, ids)
    assert torch.equal(want, embedding_lookup_reference(table, ids))
    for k in (32, 128, 1, 5, 300):
        before = gather_rows_pipelined.launches
        got = gather_rows_pipelined(table, ids, k=k)
        torch.cuda.synchronize()
        assert gather_rows_pipelined.launches == before + 1
        assert torch.equal(got, want), k
    for rows in (1, 7, 129, 1000):  # ragged last block, k = min(k, B)
        assert torch.equal(gather_rows_pipelined(table, ids[:rows], k=32), want[:rows])
    small = table[:50, :8].contiguous()
    assert torch.equal(gather_rows_pipelined(small, ids[:100], k=16),
                       embedding_lookup_reference(small, ids[:100]))
    sms = _cuda.sm_count(cuda_device)
    assert ring_plan(b, 32, d, sms).blocks >= 64
    many = torch.zeros((sms * 4 * 450,), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        gather_rows_pipelined(table, many, k=450)  # 450 rows a block: 234 KB of ring


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 32, 128, "B+1"])
@pytest.mark.parametrize("b", [1, 1024, 30720])
def test_ring_gather_kernel_grid(cuda_device, b, k):
    """K3 exact against the plain version and K2 with ids out of range, from
    one id to the lane step's 30720 (where a block's ring turns), for ring
    depths below, at and beyond a block's rows."""
    rng = np.random.default_rng(b)
    n, d = 100_000, 128
    table = torch.from_numpy(rng.normal(0, 1, (n, d)).astype(np.float32)).to(cuda_device)
    ids_np = rng.integers(0, n, b).astype(np.int32)
    edge = [-1, n, -(2**31), 2**31 - 1, n + 7]
    ids_np[-min(b, 5):] = edge[: min(b, 5)]
    ids = torch.from_numpy(ids_np).to(cuda_device)
    before = gather_rows_pipelined.launches
    got = gather_rows_pipelined(table, ids, k=b + 1 if k == "B+1" else k)
    torch.cuda.synchronize()
    assert gather_rows_pipelined.launches == before + 1
    assert torch.equal(got, embedding_lookup_reference(table, ids))
    assert torch.equal(got, embedding_lookup(table, ids))


@pytest.mark.gpu
def test_wrappers_refuse_mixed_devices_and_wrong_types(cuda_device):
    dims, batch = (24, 32, 16), 8
    x, label, weight, seeds, dense = _tower_inputs(dims, batch, "mixed", cuda_device)
    lane = lambda t: t[None].contiguous()
    lanes_args = (lane(x), lane(label), lane(weight), lane(seeds), tuple(lane(t) for t in dense))
    with pytest.raises(ValueError, match="CUDA"):
        fused_tower_grad(x, label.cpu(), weight, seeds, dense, dims, 0.0)
    with pytest.raises(ValueError, match="CUDA"):
        fused_tower_grad_lanes(lanes_args[0], lanes_args[1], lanes_args[2], lanes_args[3],
                               (lanes_args[4][0].cpu(), *lanes_args[4][1:]), dims, 0.0)
    with pytest.raises(ValueError, match="float32"):
        fused_tower_grad_lanes(lanes_args[0].double(), *lanes_args[1:], dims, 0.0)
    with pytest.raises(ValueError, match="lanes"):
        fused_tower_grad_lanes(*lanes_args[:4], tuple(t[0] for t in lanes_args[4]), dims, 0.0)
    table = torch.zeros((10, 8), device=cuda_device)
    ids = torch.zeros((4,), dtype=torch.int32, device=cuda_device)
    for gather in (embedding_lookup, gather_rows_pipelined):
        with pytest.raises(ValueError, match="CUDA"):
            gather(table, ids.cpu())
        with pytest.raises(ValueError, match="int32"):
            gather(table, ids.long())
        with pytest.raises(ValueError, match="float32"):
            gather(table.half(), ids)


@pytest.mark.gpu
@pytest.mark.parametrize("dr_parallel", ["off", "on"])
@pytest.mark.parametrize("emb_trainable", [False, True])
def test_epoch_on_the_card_small(cuda_device, dr_parallel, emb_trainable):
    """One whole epoch at a small size through the kernels: the sequential
    dr_phase through single-lane K1, the lanes through K1-lanes, with frozen
    (shared) and trainable (lane-stacked) tables; launch counts, finite
    results, every specific updated."""
    cfg = ExperimentConfig.from_dict({
        "model": {"name": "mlp_meta_mamdr_finetune", "user_dim": 8, "item_dim": 8,
                  "domain_dim": 8, "hidden_dim": [32, 16], "dropout": 0.5},
        "train": {"load_pretrain_emb": True, "emb_trainable": emb_trainable,
                  "sample_num": 2, "meta_learning_rate": 0.1, "dr_parallel": dr_parallel},
        "dataset": {"name": "synthetic", "batch_size": 32, "seed": 5},
    })
    ds = make_synthetic_dataset(n_domain=3, n_uid=50, n_pid=60, n_per_domain=300, seed=5,
                                long_tail=True, batch_size=32)
    rng = np.random.default_rng(0)
    ds.user_emb = rng.normal(0, 0.1, (50, 8)).astype(np.float32)
    ds.item_emb = rng.normal(0, 0.1, (60, 8)).astype(np.float32)
    trainer = Trainer(cfg, ds)  # no device named: the card
    strat = MAMDRStrategy(trainer)
    strat.prepare_fused()
    assert strat.dr_lanes == (dr_parallel == "on")
    spec0 = list(strat.specific)
    fused_tower_grad.launches = fused_tower_grad_lanes.launches = 0
    fused_adam_update.launches = 0
    losses = strat.run_fused_epoch()
    torch.cuda.synchronize()
    spd = trainer.steps_per_domain()
    dn_steps = sum(spd)
    if strat.dr_lanes:
        lane_steps = sum(max(spd[s] for s in strat.aux[:, j]) + max(spd)
                         for j in range(strat.aux.shape[1]))
        assert fused_tower_grad.launches == dn_steps
        assert fused_tower_grad_lanes.launches == lane_steps
        assert fused_adam_update.launches == dn_steps + lane_steps  # K4: every Adam step
    else:
        dr_steps = sum(spd[s] + spd[q] for q, row in zip(strat.order, strat.aux) for s in row)
        assert fused_tower_grad.launches == dn_steps + dr_steps
        assert fused_tower_grad_lanes.launches == 0
        assert fused_adam_update.launches == dn_steps + dr_steps
        assert int(trainer.state.step) == dn_steps + dr_steps
    assert np.all(np.isfinite(losses))
    for new, old in zip(strat.specific, spec0):
        for m, a, b in zip(trees.leaves(strat.mask), trees.leaves(new), trees.leaves(old)):
            if m:
                assert bool(torch.isfinite(a).all()) and not torch.equal(a, b)


def _small_mamdr(emb_trainable, tmp_path, device=None, dropout=0.5, n_per_domain=300,
                 batch=32, epoch=1):
    cfg = ExperimentConfig.from_dict({
        "model": {"name": "mlp_meta_mamdr_finetune", "user_dim": 8, "item_dim": 8,
                  "domain_dim": 8, "hidden_dim": [32, 16], "dropout": dropout},
        "train": {"load_pretrain_emb": True, "emb_trainable": emb_trainable, "epoch": epoch,
                  "patience": 2, "learning_rate": 1e-2, "sample_num": 2,
                  "meta_learning_rate": 0.1, "checkpoint_path": str(tmp_path)},
        "dataset": {"name": "synthetic", "batch_size": batch, "seed": 21},
    })
    ds = make_synthetic_dataset(n_domain=3, n_uid=50, n_pid=60, n_per_domain=n_per_domain,
                                seed=21, long_tail=True, batch_size=batch)
    rng = np.random.default_rng(0)
    ds.user_emb = rng.normal(0, 0.1, (50, 8)).astype(np.float32)
    ds.item_emb = rng.normal(0, 0.1, (60, 8)).astype(np.float32)
    return MAMDRStrategy(Trainer(cfg, ds, device=device, verbose=False))


@pytest.mark.gpu
@pytest.mark.parametrize("emb_trainable", [False, True])
def test_lane_eval_through_k2_equals_the_plain_gather(cuda_device, tmp_path, emb_trainable):
    """The merged eval's lanes through K2 against the same eval through the
    plain gather: K2 copies rows and the products are the same calls, so the
    logits, losses and confusion counts are equal bit for bit."""
    from mamdr_tpu_torch.strategies import ops as weight_ops
    from mamdr_tpu_torch.train import fused

    strat = _small_mamdr(emb_trainable, tmp_path)
    t = strat.trainer
    stack = fused.stack_specific(strat.specific, strat.mask)
    params = weight_ops.load_masked(
        t.state.params, weight_ops.merge_weights(strat.shared, stack, strat.mask, "plus"),
        strat.mask)
    block = t.eval_block("val")
    b = {k: v[:, 0].contiguous() for k, v in block.items()}
    before = gather_fields.launches
    logits_k = t.model.apply_lanes(params["model"], b["uid"], b["pid"], b["domain"])
    assert gather_fields.launches == before + 1 and not logits_k.requires_grad
    logits_p = t.model.apply_lanes(params["model"], b["uid"], b["pid"], b["domain"],
                                   gather=gather_fields_reference)
    assert torch.equal(logits_k, logits_p)
    loss_k, counts_k = fused.make_lane_eval(t.model, t.step_cfg)(params, block)
    loss_p, counts_p = fused.make_lane_eval(t.model, t.step_cfg,
                                            gather=gather_fields_reference)(params, block)
    assert torch.equal(loss_k, loss_p)
    assert all(torch.equal(a, c) for a, c in zip(counts_k, counts_p))
    gather_fields.launches = 0
    _, avg_auc, _, domain_auc = strat.validate()
    assert gather_fields.launches == block["weight"].shape[1]
    assert all(0.0 <= v <= 1.0 for v in domain_auc.values())


@pytest.mark.gpu
@pytest.mark.parametrize("emb_trainable", [False, True])
def test_finetune_lane_step_held_to_the_plain_version(cuda_device, tmp_path, emb_trainable):
    """A finetune SGD lane-step: K1-lanes held to its plain version on the
    step's operands (kernel_check.k1_vs_plain); then the whole finetune
    stage's launches: one K1-lanes and one K2 a lane-step, one K2 an eval
    lane-step."""
    from mamdr_tpu_torch.ops.fused_mlp_step import make_fast_loss_grad
    from mamdr_tpu_torch.strategies import separate
    from mamdr_tpu_torch.train.steps import make_subset_train_step

    strat = _small_mamdr(emb_trainable, tmp_path)
    t = strat.trainer
    lanes = separate.make_lanes(t, False, strat._best_params_fn)
    seen = []

    def spy(*a):
        seen[:] = a
        return fused_tower_grad_lanes(*a)

    step = make_subset_train_step(t.model, t.finetune_tx, t.step_cfg, t.frozen_mask(),
                                  t.state.params,
                                  loss_grad=make_fast_loss_grad(t.model, t.step_cfg,
                                                                tower_grad=spy))[0]
    batch = t.dataset.batch_size
    new, loss = step(lanes.states, {k: v[:, :batch].contiguous() for k, v in lanes.block.items()})
    assert loss.shape == (3,) and bool(torch.all(new.step == 1))
    k1_vs_plain(fused_tower_grad_lanes, tower_grad_reference_lanes, *seen, K1_REL_TOL)

    fused_tower_grad.launches = fused_tower_grad_lanes.launches = gather_fields.launches = 0
    _, _, _, domain_auc = strat.finetune()
    steps = max(t.steps_per_domain())
    val_steps = max(t.eval_steps_per_domain("val"))
    test_steps = max(t.eval_steps_per_domain("test"))
    assert fused_tower_grad.launches == 0
    assert fused_tower_grad_lanes.launches == steps  # one epoch
    assert gather_fields.launches == steps + val_steps + test_steps
    assert all(0.0 <= v <= 1.0 for v in domain_auc.values())


@pytest.mark.gpu
def test_run_on_the_card_matches_the_cpu_small(cuda_device, tmp_path):
    """A whole run() (3 epochs, test, finetune) through the kernels against
    the same run() through the plain versions on the CPU: one batch a
    domain, so the two devices' shuffles permute the same rows; dropout off.
    Test loss within 1e-3 relative, AUC within 1e-3."""
    card = _small_mamdr(False, tmp_path / "card", None, 0.0, 100, 64, 3).run()
    cpu = _small_mamdr(False, tmp_path / "cpu", "cpu", 0.0, 100, 64, 3).run()
    for k, v in cpu[2].items():
        assert abs(card[2][k] - v) <= 1e-3 * abs(v)
        assert abs(card[3][k] - cpu[3][k]) <= 1e-3


def _small_run(name, tmp_path, device=None, **train):
    """run() of `name` on 3 small domains (one batch a domain, dropout off),
    3 epochs; returns (result, strategy)."""
    from mamdr_tpu_torch.strategies.base import build_strategy

    cfg = ExperimentConfig.from_dict({
        "model": {"name": name, "user_dim": 8, "item_dim": 8, "domain_dim": 8,
                  "hidden_dim": [32, 16], "dropout": 0.0},
        "train": {"load_pretrain_emb": True, "emb_trainable": False, "epoch": 3,
                  "patience": 2, "learning_rate": 1e-2, "meta_learning_rate": 0.1,
                  "checkpoint_path": str(tmp_path), **train},
        "dataset": {"name": "synthetic", "batch_size": 64, "seed": 21},
    })
    ds = make_synthetic_dataset(n_domain=3, n_uid=50, n_pid=60, n_per_domain=100, seed=21,
                                long_tail=True, batch_size=64)
    rng = np.random.default_rng(0)
    ds.user_emb = rng.normal(0, 0.1, (50, 8)).astype(np.float32)
    ds.item_emb = rng.normal(0, 0.1, (60, 8)).astype(np.float32)
    strat = build_strategy(Trainer(cfg, ds, device=device, verbose=False))
    return strat.run(), strat


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["mlp", "mlp_separate", "mlp_finetune",
                                  "mlp_meta_domain_negotiation_finetune",
                                  "mlp_meta_reptile_finetune",
                                  "mlp_meta_reptile_batch_finetune"])
def test_strategy_run_on_the_card_matches_the_cpu_small(cuda_device, tmp_path, name):
    """Joint, separate, finetune, DN and Reptile: a whole run() through the
    kernels (K1 one lane or K1-lanes, and K2, launched) against the same
    run() through the plain versions on the CPU. Test loss within 1e-3
    relative, AUC within 1e-3."""
    fused_tower_grad.launches = fused_tower_grad_lanes.launches = gather_fields.launches = 0
    card, _ = _small_run(name, tmp_path / "card")
    if name == "mlp_separate":
        assert fused_tower_grad.launches == 0 and fused_tower_grad_lanes.launches > 0
    else:
        assert fused_tower_grad.launches > 0
    assert gather_fields.launches > 0
    cpu, _ = _small_run(name, tmp_path / "cpu", "cpu")
    for k, v in cpu[2].items():
        assert abs(card[2][k] - v) <= 1e-3 * abs(v)
        assert abs(card[3][k] - cpu[3][k]) <= 1e-3


META_RUNS = [  # the corpus's meta split for MAML and MLDG
    ("mlp_meta_maml_finetune", {"meta_split": "meta-train/val", "meta_split_ratio": 0.2}),
    ("mlp_meta_mldg_finetune", {"meta_split": "meta-train/val", "meta_split_ratio": 0.8}),
    ("mlp_pcgrad", {"sample_num": 2}),
    ("mlp_uncertainty_weight", {}),
]


@pytest.mark.gpu
@pytest.mark.parametrize("name,train", META_RUNS)
def test_meta_strategy_run_on_the_card_matches_the_cpu_small(cuda_device, tmp_path, name,
                                                             train):
    """MAML, MLDG, PCGrad and uncertainty weighting: a whole run() through
    the kernels (K1 at rate 0 on the accumulate steps; uncertainty weighting
    through autograd, K2 only) against the same run() through the plain
    versions on the CPU. Test loss within 1e-3 relative, AUC within 1e-3."""
    train = {"meta_learning_rate": 1e-2, **train}
    fused_tower_grad.launches = fused_tower_grad_lanes.launches = gather_fields.launches = 0
    card, strat = _small_run(name, tmp_path / "card", **train)
    if name == "mlp_uncertainty_weight":
        assert fused_tower_grad.launches == 0
        assert not torch.equal(strat.trainer.state.params["uncertainty"]["log_vars"],
                               torch.ones_like(strat.trainer.state.params["uncertainty"]
                                               ["log_vars"]))
    else:
        assert fused_tower_grad.launches > 0
    assert gather_fields.launches > 0
    cpu, _ = _small_run(name, tmp_path / "cpu", "cpu", **train)
    for k, v in cpu[2].items():
        assert abs(card[2][k] - v) <= 1e-3 * abs(v)
        assert abs(card[3][k] - cpu[3][k]) <= 1e-3


ZOO_SMALL = {"user_dim": 8, "item_dim": 8, "domain_dim": 8, "hidden_dim": [16, 8],
             "tower_hidden_dim": [8], "num_experts": 3, "gate_dnn_hidden_units": [8],
             "specific_expert_num": 2, "shared_expert_num": 1, "num_levels": 1}
ZOO = ["wdl", "deepfm", "nfm", "autoint", "ccpm", "pnn", "shared_bottom", "mmoe", "ple"]


def _zoo_trainer(name, tmp_path, device, dropout=0.0, **train):
    cfg = ExperimentConfig.from_dict({
        "model": {"name": name, **ZOO_SMALL, "dropout": dropout},
        "train": {"load_pretrain_emb": True, "emb_trainable": False, "epoch": 3,
                  "patience": 2, "learning_rate": 1e-2, "meta_learning_rate": 0.1,
                  "sample_num": 2, "checkpoint_path": str(tmp_path), **train},
        "dataset": {"name": "synthetic", "batch_size": 64, "seed": 21},
    })
    ds = make_synthetic_dataset(n_domain=3, n_uid=50, n_pid=60, n_per_domain=100, seed=21,
                                long_tail=True, batch_size=64)
    rng = np.random.default_rng(0)
    ds.user_emb = rng.normal(0, 0.1, (50, 8)).astype(np.float32)
    ds.item_emb = rng.normal(0, 0.1, (60, 8)).astype(np.float32)
    return Trainer(cfg, ds, device=device, verbose=False)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ZOO)
def test_autograd_lane_step_through_k2_equals_the_plain_gather(cuda_device, tmp_path, name):
    """The zoo's autograd lane step (3 lanes, each its own weights, domain
    and dropout seeds; the domain table lane-stacked, the frozen tables
    shared) through K2 against the same step through K2's plain version:
    K2 copies rows exactly, so the losses agree and the gradients (the
    lane-stacked domain table's among them, summed by index_add_ in another
    order) within 1e-5 of each tensor's max."""
    from mamdr_tpu_torch.train.steps import make_autograd_loss_grad
    from mamdr_tpu_torch.utils.kernel_check import worst_errors

    t = _zoo_trainer(name, tmp_path, None, dropout=0.5)
    lanes = 3
    frozen = trees.named_tree_map(lambda n, x: "user_emb" in n or "item_emb" in n,
                                  t.state.params)
    params = trees.tree_map(
        lambda f, x: x if f else torch.stack([x * (1.0 + 0.1 * l) for l in range(lanes)]),
        frozen, t.state.params)
    cols = {k: v[:, :64].contiguous() for k, v in t.train_block()[0].items()}
    seeds = torch.randint(0, 2**32, (lanes, t.model.n_dropout_sites), device=cuda_device)
    gather_fields.launches = 0
    data_k, g_k = make_autograd_loss_grad(t.model, t.step_cfg)(params, cols, seeds)
    assert gather_fields.launches == 1
    data_p, g_p = make_autograd_loss_grad(t.model, t.step_cfg, gather_fields_reference)(
        params, cols, seeds)
    assert data_k.shape == (lanes,)
    assert g_k["model"]["embedding"]["domain_emb"].shape == (lanes, 3, 8)
    got = [data_k] + [g for g in trees.leaves(g_k) if g is not None]
    want = [data_p] + [g for g in trees.leaves(g_p) if g is not None]
    assert [g is None for g in trees.leaves(g_k)] == trees.leaves(frozen)
    _, rel = worst_errors(got, want)
    assert rel <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("name", ZOO + ["deepfm_meta_mamdr_finetune",
                                        "mmoe_meta_mamdr_finetune",
                                        "mlp_uncertainty_weight_finetune"])
def test_zoo_run_on_the_card_matches_the_cpu_small(cuda_device, tmp_path, name):
    """A whole run() of each new name through K2 (forward and its autograd
    rule; no K1) against the same run() through the plain versions on the
    CPU. Test loss within 1e-3 relative, AUC within 1e-3."""
    from mamdr_tpu_torch.strategies.base import build_strategy

    fused_tower_grad.launches = fused_tower_grad_lanes.launches = gather_fields.launches = 0
    card = build_strategy(_zoo_trainer(name, tmp_path / "card", None)).run()
    if not name.startswith("mlp"):
        assert fused_tower_grad.launches == fused_tower_grad_lanes.launches == 0
    assert gather_fields.launches > 0
    cpu = build_strategy(_zoo_trainer(name, tmp_path / "cpu", "cpu")).run()
    for k, v in cpu[2].items():
        assert abs(card[2][k] - v) <= 1e-3 * abs(v)
        assert abs(card[3][k] - cpu[3][k]) <= 1e-3


def _star_trainer(name, tmp_path, device, **train):
    """A small STAR trainer (PartitionedNorm, StarFCN, the corpus's meta_parms)."""
    cfg = ExperimentConfig.from_dict({
        "model": {"name": name, "user_dim": 8, "item_dim": 8, "domain_dim": 8,
                  "hidden_dim": [16, 8], "auxiliary_dim": 8, "norm": "pn", "dense": "star"},
        "train": {"load_pretrain_emb": True, "emb_trainable": False, "epoch": 3,
                  "patience": 2, "learning_rate": 1e-2, "meta_learning_rate": 0.1,
                  "sample_num": 2, "meta_parms": ["emb", "kernel_shared", "bias_shared"],
                  "checkpoint_path": str(tmp_path), **train},
        "dataset": {"name": "synthetic", "batch_size": 64, "seed": 21},
    })
    ds = make_synthetic_dataset(n_domain=3, n_uid=50, n_pid=60, n_per_domain=100, seed=21,
                                long_tail=True, batch_size=64)
    rng = np.random.default_rng(0)
    ds.user_emb = rng.normal(0, 0.1, (50, 8)).astype(np.float32)
    ds.item_emb = rng.normal(0, 0.1, (60, 8)).astype(np.float32)
    return Trainer(cfg, ds, device=device, verbose=False)


@pytest.mark.gpu
def test_star_step_and_finetune_lane_step_through_k2_equal_the_plain_gather(cuda_device,
                                                                           tmp_path):
    """STAR's autograd train step (one tower, PartitionedNorm in train mode)
    and one finetune lane-step (3 domain lanes of SGD, the statistics
    lane-stacked) through K2 against the same through K2's plain version:
    the loss, gradients, new params and new statistics within 1e-4 of each
    tensor's max; one K2 launch each. The domain table's gradient is held
    to 1e-4 of the step's largest gradient instead: the norm's backward
    cancels the rows' terms on the domain columns (constant in a one-domain
    batch), so that gradient is its l2 term (~1e-6) plus the rounding of a
    sum of terms of the other gradients' size, which K2's scatter-add takes
    in another order."""
    from mamdr_tpu_torch.strategies import separate
    from mamdr_tpu_torch.strategies.base import build_strategy
    from mamdr_tpu_torch.train.steps import make_autograd_loss_grad, make_subset_train_step
    from mamdr_tpu_torch.utils.kernel_check import worst_errors

    t = _star_trainer("star_meta_mamdr_finetune", tmp_path, None)
    cols = {k: v[0, :64] for k, v in t.train_block()[0].items()}
    gather_fields.launches = 0
    out_k = make_autograd_loss_grad(t.model, t.step_cfg)(t.state.params, cols, None,
                                                         stats=t.state.batch_stats)
    assert gather_fields.launches == 1
    out_p = make_autograd_loss_grad(t.model, t.step_cfg, gather_fields_reference)(
        t.state.params, cols, None, stats=t.state.batch_stats)
    dom_k, dom_p = out_k[1]["model"]["domain_emb"], out_p[1]["model"]["domain_emb"]
    flat = lambda o: [o[0]] + [g for n, g in trees.leaves_with_names(o[1])
                               if g is not None and n != "model/domain_emb"] + trees.leaves(o[2])
    _, rel = worst_errors(flat(out_k), flat(out_p))
    assert rel <= 1e-4
    largest = max(float(g.abs().max()) for g in trees.leaves(out_p[1]) if g is not None)
    assert float((dom_k - dom_p).abs().max()) <= 1e-4 * largest

    lanes = separate.make_lanes(t, init_params=False,
                                params_fn=build_strategy(t)._best_params_fn)
    lane_cols = {k: v[:, :64].contiguous() for k, v in lanes.block.items()}
    frozen = trees.named_tree_map(lambda n, x: "user_emb" in n or "item_emb" in n,
                                  t.state.params)
    kernel_step, _, _ = make_subset_train_step(t.model, t.finetune_tx, t.step_cfg, frozen,
                                               t.state.params)
    plain_step, _, _ = make_subset_train_step(
        t.model, t.finetune_tx, t.step_cfg, frozen, t.state.params,
        loss_grad=make_autograd_loss_grad(t.model, t.step_cfg, gather_fields_reference))
    gather_fields.lane_launches = 0
    sk, lk = kernel_step(lanes.states, lane_cols)
    assert gather_fields.lane_launches == 1
    sp, lp = plain_step(lanes.states, lane_cols)
    assert sk.batch_stats["partitioned_norm"]["moving_mean"].shape == (3, 3, 24)
    state_flat = lambda st, loss: [loss] + [x for x in trees.leaves(st.params)
                                            if x.dim() > 0] + trees.leaves(st.batch_stats)
    _, rel = worst_errors(state_flat(sk, lk), state_flat(sp, lp))
    assert rel <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["star", "star_meta_mamdr_finetune"])
def test_star_run_on_the_card_matches_the_cpu_small(cuda_device, tmp_path, name):
    """A whole STAR run() through K2 (no K1) against the same run() on the
    CPU: test loss within 1e-3 relative, AUC within 1e-3. MAMDR's inner
    optimizer is SGD: PartitionedNorm makes the domain columns' gradients
    rounding noise, which Adam would scale up differently on the two
    devices."""
    from mamdr_tpu_torch.strategies.base import build_strategy

    train = {"optimizer": "sgd", "learning_rate": 0.1} if "mamdr" in name else {}
    fused_tower_grad.launches = fused_tower_grad_lanes.launches = gather_fields.launches = 0
    card = build_strategy(_star_trainer(name, tmp_path / "card", None, **train)).run()
    assert fused_tower_grad.launches == fused_tower_grad_lanes.launches == 0
    assert gather_fields.launches > 0
    cpu = build_strategy(_star_trainer(name, tmp_path / "cpu", "cpu", **train)).run()
    for k, v in cpu[2].items():
        assert abs(card[2][k] - v) <= 1e-3 * abs(v)
        assert abs(card[3][k] - cpu[3][k]) <= 1e-3


# ---- K4: the train step's Adam, apply and all-pad gate in one pass ----

A13_MLP_LEAVES = {  # the benchmark cell's MLP: n = 25,741,440 floats a lane
    "dnn": {f"Dense_{i}": {"Dense_0": {"kernel": (a, b), "bias": (b,)}}
            for i, (a, b) in enumerate(((384, 256), (256, 128), (128, 64)))},
    "embedding": {"user_emb": (100000, 128), "item_emb": (100000, 128),
                  "domain_emb": (13, 128)},
    "logit": {"Dense_0": {"Dense_0": {"kernel": (64, 1)}}},
}


def _adam_case(shapes, lanes, count, device, emb_trainable=True, seed=0):
    """A tree of ``shapes`` ([lanes, ...] where ``lanes``; frozen tables
    without a lane axis), its Adam (lr 1e-3), a state at ``count``, random
    gradients, and has_data with lane 1 all padding where lanes > 1."""
    gen = torch.Generator(device=device).manual_seed(seed)
    lead = () if lanes is None else (lanes,)
    frozen = lambda n: not emb_trainable and n.endswith(("user_emb", "item_emb"))  # noqa: E731
    rand = lambda s, scale: torch.randn(s, generator=gen, device=device) * scale  # noqa: E731
    tx = make_optimizer("adam", 1e-3, {"model": shapes}, emb_trainable)
    params = trees.named_tree_map(
        lambda n, s: rand(s if frozen(n) else lead + s, 0.1), {"model": shapes})
    grads = trees.named_tree_map(
        lambda n, m, x: rand(x.shape, 1.0) if m else None, tx.mask, params)
    n = sum(x[(0,) * len(lead)].numel() for m, x in
            zip(trees.leaves(tx.mask), trees.leaves(params)) if m)
    state = FlatAdamState(count=torch.full(lead, count, dtype=torch.int32, device=device),
                          mu=rand(lead + (n,), 1e-2),
                          nu=torch.rand(lead + (n,), generator=gen, device=device) * 1e-3)
    has_data = torch.ones(lead, dtype=torch.bool, device=device)
    if lanes is not None and lanes > 1:
        has_data[1] = False
    return tx, params, grads, state, has_data


def _three_stage_step(tx, params, grads, state, has_data):
    """The train step's path before K4: ``update``, ``apply_updates``, and
    the gate's ``torch.where`` of every tensor it carries."""
    updates, new_opt = tx.update(grads, state)
    new_params = apply_updates(params, updates)

    def keep(new, old):
        return old if new is old else torch.where(
            has_data[(...,) + (None,) * (new.dim() - has_data.dim())], new, old)

    return (trees.tree_map(keep, new_params, params),
            type(state)(*(keep(n, o) for n, o in zip(new_opt, state))))


def _held_bit_for_bit(tx, params, grads, state, has_data):
    """K4 through ``FlatAdam.step`` and through its wrapper against the
    three-stage path and the plain version, bit for bit; a frozen leaf is
    the same tensor, an all-pad lane keeps its leaves, slots and count."""
    before = fused_adam_update.launches
    got_p, got_s = tx.step(params, grads, state, has_data)
    torch.cuda.synchronize()
    assert fused_adam_update.launches == before + 1
    want_p, want_s = _three_stage_step(tx, params, grads, state, has_data)
    for (name, a), b, m, old in zip(trees.leaves_with_names(got_p), trees.leaves(want_p),
                                    trees.leaves(tx.mask), trees.leaves(params)):
        assert torch.equal(a, b), name
        if not m:
            assert a is old, name
        elif has_data.numel() > 1 and not bool(has_data[1]):
            assert torch.equal(a[1], old[1]), name
    for a, b, old in zip(got_s, want_s, state):
        assert torch.equal(a, b)
        if has_data.numel() > 1 and not bool(has_data[1]):
            assert torch.equal(a[1], old[1])
    lead = state.mu.shape[:-1]
    sel = lambda t: [x for m, x in zip(trees.leaves(tx.mask), trees.leaves(t)) if m]  # noqa
    c = (state.count + 1).to(torch.float32).reshape(*lead, 1)
    args = (sel(params), sel(grads), state.mu, state.nu, 1.0 - tx.b1 ** c, 1.0 - tx.b2 ** c,
            has_data, tx.learning_rate, tx.b1, tx.b2, tx.eps)
    outs, mu, nu = adam_update_reference(*args)
    assert all(torch.equal(a, b) for a, b in zip(sel(got_p), outs))
    assert torch.equal(got_s.mu, mu) and torch.equal(got_s.nu, nu)


@pytest.mark.gpu
@pytest.mark.parametrize("count", [0, 159])  # the step's count: 1 and 160
@pytest.mark.parametrize("lanes", [None, 6, 7])
def test_adam_kernel_bit_equal_at_the_cells_shapes(cuda_device, lanes, count):
    """The cell's 10 MLP leaves (trainable 100000 x 128 tables), one tower
    and the DR groups' 6 and 7 lanes, lane 1 all padding."""
    _held_bit_for_bit(*_adam_case(A13_MLP_LEAVES, lanes, count, cuda_device))
    torch.cuda.empty_cache()


# slot offsets 0, 1, 4098, 4113, 12304, 12432, 12460: a to d on the scalar
# path, e and the tables on the float4 path
ODD_LEAVES = {"a": (1,), "b": (4097,), "c": (3, 5), "d": (8191,), "e": (2, 64),
              "user_emb": (9, 4), "item_emb": (7, 4)}


@pytest.mark.gpu
@pytest.mark.parametrize("emb_trainable", [True, False])
@pytest.mark.parametrize("lanes", [None, 1, 3])
def test_adam_kernel_takes_odd_leaves(cuda_device, lanes, emb_trainable):
    """A 1-element leaf, slot offsets off float4 alignment (scalar path),
    frozen tables (mask False: untouched, the same tensors), and with lanes
    slots and a leaf broadcast from one lane (``expand``, stride 0), as a
    lane state is before its first step; then a float4 leaf whose base
    address is off 16 bytes (a view one float in: the scalar path)."""
    tx, params, grads, state, has_data = _adam_case(ODD_LEAVES, lanes, 3, cuda_device,
                                                    emb_trainable, seed=1)
    _held_bit_for_bit(tx, params, grads, state, has_data)
    if lanes is not None:
        wide = lambda x: x[0].expand(x.shape)  # noqa: E731
        state = FlatAdamState(count=state.count, mu=wide(state.mu), nu=wide(state.nu))
        params["model"]["b"] = wide(params["model"]["b"])
        params["model"]["e"] = wide(params["model"]["e"])
        _held_bit_for_bit(tx, params, grads, state, has_data)
    shape = params["model"]["e"].shape
    base = torch.randn(shape.numel() + 1, device=cuda_device)
    params["model"]["e"] = base[1:].view(shape)
    _held_bit_for_bit(tx, params, grads, state, has_data)


@pytest.mark.gpu
def test_adam_kernel_refuses_what_it_does_not_take(cuda_device):
    tx, params, grads, state, has_data = _adam_case(ODD_LEAVES, 3, 0, cuda_device)
    sel = lambda t: [x for m, x in zip(trees.leaves(tx.mask), trees.leaves(t)) if m]  # noqa
    c = (state.count + 1).to(torch.float32).reshape(3, 1)
    bc = (1.0 - tx.b1 ** c, 1.0 - tx.b2 ** c)

    def call(p=None, g=None, mu=state.mu, nu=state.nu, has=has_data):
        return fused_adam_update(p or sel(params), g or sel(grads), mu, nu, *bc, has,
                                 tx.learning_rate, tx.b1, tx.b2, tx.eps)

    p = sel(params)
    with pytest.raises(ValueError, match="contiguous"):
        call(p=[p[0]] + [p[1], p[2].transpose(1, 2).contiguous().transpose(1, 2)] + p[3:])
    with pytest.raises(ValueError, match="float32"):
        call(p=[p[0].double()] + p[1:])
    with pytest.raises(ValueError, match="float32"):
        call(mu=state.mu.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        call(g=[g.transpose(1, 2).contiguous().transpose(1, 2) if g.dim() == 3 else g
                for g in sel(grads)])
    with pytest.raises(ValueError, match="CUDA"):
        call(g=[sel(grads)[0].cpu()] + sel(grads)[1:])
    with pytest.raises(ValueError, match="bool"):
        call(has=has_data.int())
    with pytest.raises(ValueError, match="lane"):
        call(mu=state.mu[:2], nu=state.nu[:2])
