"""Embedding lookups: the field gather that writes the tower input, and the
row gather, both with clip semantics.

Counterpart of ``mamdr_tpu/ops/embedding_lookup.py::embedding_lookup``
(``jnp.take(..., mode="clip")``: out-of-range ids are clamped, as TF does)
and of the ``jnp.concatenate`` of field lookups that forms the MLP tower's
input (``mamdr_tpu/ops/fused_mlp_step.py:252-255``,
``mamdr_tpu/models/deepctr.py:92-94``). ``gather_fields`` gathers up to four
fields (tables with their ids, for one tower or for L lanes) straight into
their column ranges of one output, in ONE launch of kernel K2
(``csrc/gather_rows.cu``), which replaces the Pallas row gather
``pallas_gather_rows`` (``mamdr_tpu/ops/embedding_lookup.py:56``) and clamps
every id to its own lane's rows inside the kernel. It can also return the
flat row ids it read, which the train step's scatter-add of the gradient
takes; where a table requires a gradient it is an autograd function whose
backward is that scatter-add (``jnp.take(mode="clip")``'s gradient).
``embedding_lookup`` is its one-field case. On CPU tensors both run the
plain version (``gather_fields_reference``: ``table_rows`` of each field and
``torch.cat``).

``gather_rows_pipelined`` is the counterpart of
``pallas_gather_rows_pipelined`` (``:103``): the same gather through rings
of row copies in flight, ``k`` deep in each block, dealt over the card's SMs
(``csrc/gather_rows_pipelined.cu``, kernel K3; ``ring_plan`` is its launch).
As in the JAX package it is a probe (``mamdr_tpu_torch/probe_gather.py``), on
no training path.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from mamdr_tpu_torch.ops import _cuda
from mamdr_tpu_torch.utils import trace


def embedding_lookup_reference(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: table [N, D], ids [B] -> [B, D], ids clamped."""
    return table[ids.long().clamp(0, table.shape[0] - 1)]


CLAMP, WINDOW, SILENT = 0, 1, 2  # a field's read: K2's ``Field.mode``


def table_rows(table, ids, window=None):
    """Rows of one field's table for one tower or for L lanes, by plain
    indexing: the building block of ``gather_fields_reference``.

    ``table`` [N, D] is one table: the single tower's (ids [B]) or one that
    every lane reads (ids [L, B], flattened across lanes). ``table``
    [L, N, D] holds a table per lane and is indexed as its [L*N, D] view,
    ids [L, B] clipped to the lane's rows before the lane's offset is added,
    so clip semantics hold per lane. Returns (rows [*ids.shape, D], the flat
    row ids read: clamped, lane offset added, ids' dtype).

    ``window`` (row_lo, mode) reads the table as rows [row_lo, row_lo + N)
    of a larger one: ``WINDOW`` gives an id outside them zeros and the flat
    id of the spare row one past the table's [L*N or N, D] view, which
    ``scatter_rows`` drops; ``SILENT`` gives zeros with the clamped flat id;
    None or mode ``CLAMP`` is the clamp.
    """
    lo, mode = window or (0, CLAMP)
    lanes, n = (1, table.shape[0]) if table.dim() == 2 else table.shape[:2]
    offset = (torch.arange(lanes, dtype=ids.dtype, device=ids.device)[:, None] * n
              if table.dim() == 3 else 0)
    view = table.reshape(-1, table.shape[-1])
    if mode == WINDOW:
        local = ids.long() - int(lo)
        inside = (local >= 0) & (local < n)
        flat = torch.where(inside, local.clamp(0, n - 1) + offset, view.shape[0])
        read = view[flat.reshape(-1).clamp(max=view.shape[0] - 1)]
        rows = torch.where(inside.reshape(-1, 1), read, 0.0)
        return rows.reshape(*ids.shape, -1), flat.to(ids.dtype).reshape(-1)
    flat = (ids.clamp(0, n - 1) + offset).reshape(-1)
    rows = embedding_lookup_reference(view, flat)
    if mode == SILENT:  # zeros whose gradient still reaches the rows, as K2's rule
        rows = rows - rows.detach()
    return rows.reshape(*ids.shape, -1), flat


def scatter_rows(table_shape, flat: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The gradient of a gather with respect to its table: zeros of
    ``table_shape`` ([N, D], or [L, N, D] as its [L*N, D] view) with each of
    ``rows`` [..., D] added at its flat row id (``table_rows``' second
    result). ``jnp.take(mode="clip")``'s gradient (XLA's scatter in the JAX
    package, not a Pallas kernel; ``index_add_`` here). A flat id one past
    the view (a windowed gather's row outside its shard) lands in a spare row
    that the result leaves out."""
    d = table_shape[-1]
    n = 1
    for s in table_shape[:-1]:
        n *= int(s)
    g = torch.zeros((n + 1, d), dtype=rows.dtype, device=rows.device)
    g.index_add_(0, flat.long(), rows.reshape(-1, d))
    return g[:n].view(table_shape)


def _mask(train_mask, n: int) -> Tuple[bool, ...]:
    mask = (False,) * n if train_mask is None else tuple(bool(m) for m in train_mask)
    if len(mask) != n:
        raise ValueError(f"train_mask has {len(mask)} entries for {n} fields")
    return mask


def _windows(windows, n: int):
    w = (None,) * n if windows is None else tuple(windows)
    if len(w) != n:
        raise ValueError(f"{len(w)} windows for {n} fields")
    return tuple((0, CLAMP) if x is None else (int(x[0]), int(x[1])) for x in w)


def gather_fields_reference(tables: Sequence[torch.Tensor], ids: Sequence[torch.Tensor],
                            train_mask: Optional[Sequence[bool]] = None, windows=None):
    """Plain PyTorch version of ``gather_fields``: ``table_rows`` of each
    field (with its window), concatenated. Differentiable through indexing."""
    parts = [table_rows(t, i, w)
             for t, i, w in zip(tables, ids, _windows(windows, len(tables)))]
    mask = _mask(train_mask, len(parts))
    x = torch.cat([rows for rows, _ in parts], dim=-1)
    return x, tuple(flat if m else None for (_, flat), m in zip(parts, mask))


K2_MAX_FIELDS = 4       # descriptors the kernel's parameter struct holds
K2_WARPS_PER_BLOCK = 4  # a block's warps, one an output row (2 and 8 time the same)


class FieldPlan(NamedTuple):
    """Kernel K2's launch for a set of fields (see ``field_plan``)."""
    lanes: int                  # L (1 for one tower)
    batch: int                  # ids of one lane
    rows: int                   # output rows: lanes * batch
    widths: Tuple[int, ...]     # D of each field
    offsets: Tuple[int, ...]    # first output column of each field
    n_rows: Tuple[int, ...]     # rows of one lane's table, each field
    lane_strides: Tuple[int, ...]  # rows between lanes' tables: 0 shared, N stacked
    blocks: int                 # grid: one warp an output row
    threads: int                # a block (the C entry refuses more than 128)


def field_plan(table_shapes: Sequence[Tuple[int, ...]], ids_shape: Tuple[int, ...]) -> FieldPlan:
    """Kernel K2's launch, in plain Python, for fields whose tables have
    ``table_shapes`` and whose ids all have ``ids_shape``: [B] (one tower,
    tables [N, D]) or [L, B] (L lanes; a table [N, D] is read by every lane,
    a table [L, N, D] is one a lane). Fields fill the output's columns in
    order. Raises ``ValueError`` for what the kernel does not take: no field
    or more than four, a width no multiple of 4 (a float4 unit), an empty
    table, a lane-stacked table for one tower or for another number of
    lanes, and row ids past int32."""
    shapes = [tuple(int(n) for n in s) for s in table_shapes]
    if not 1 <= len(shapes) <= K2_MAX_FIELDS:
        raise ValueError(f"gather_fields takes 1 to {K2_MAX_FIELDS} fields, got {len(shapes)}")
    if len(ids_shape) not in (1, 2):
        raise ValueError(f"ids must be [B] or [L, B], got {tuple(ids_shape)}")
    lanes, batch = (1, ids_shape[0]) if len(ids_shape) == 1 else tuple(ids_shape)
    widths, offsets, n_rows, strides, off = [], [], [], [], 0
    for s in shapes:
        if len(s) == 3 and (len(ids_shape) != 2 or s[0] != lanes):
            raise ValueError(f"a lane-stacked table {s} needs ids [{s[0]}, B], got "
                             f"{tuple(ids_shape)}")
        if len(s) not in (2, 3):
            raise ValueError(f"a table must be [N, D] or [L, N, D], got {s}")
        n, d = s[-2:]
        if n < 1:
            raise ValueError("empty table")
        if d < 4 or d % 4 != 0:
            raise ValueError(f"gather_fields needs D % 4 == 0, got D {d}")
        if (s[0] if len(s) == 3 else 1) * n >= 2**31:
            raise ValueError(f"a table of {s} has row ids past int32")
        widths.append(d)
        offsets.append(off)
        n_rows.append(n)
        strides.append(n if len(s) == 3 else 0)
        off += d
    rows = lanes * batch
    return FieldPlan(lanes, batch, rows, tuple(widths), tuple(offsets), tuple(n_rows),
                     tuple(strides), -(-rows // K2_WARPS_PER_BLOCK), 32 * K2_WARPS_PER_BLOCK)


class _Field(ctypes.Structure):
    _fields_ = [("table", ctypes.c_void_p), ("ids", ctypes.c_void_p), ("flat", ctypes.c_void_p),
                ("n_rows", ctypes.c_int), ("lane_stride", ctypes.c_int),
                ("d4", ctypes.c_int), ("off4", ctypes.c_int),
                ("row_lo", ctypes.c_int), ("mode", ctypes.c_int)]


class _GatherPlan(ctypes.Structure):
    """The kernel's ``Plan``, passed by pointer and copied by value into the
    launch's parameters."""
    _fields_ = [("field", _Field * K2_MAX_FIELDS), ("n_fields", ctypes.c_int),
                ("batch", ctypes.c_int), ("rows", ctypes.c_int), ("out_d4", ctypes.c_int)]


@functools.lru_cache(maxsize=None)
def _bind():
    """The kernel entry of the built library, bound once."""
    lib = _cuda.load("gather_rows")
    if lib.mamdr_gather_fields_plan_bytes() != ctypes.sizeof(_GatherPlan):
        raise RuntimeError("gather_fields: the library's Plan and its ctypes mirror differ")
    fn = lib.mamdr_gather_fields
    fn.argtypes = [ctypes.POINTER(_GatherPlan), ctypes.c_int, ctypes.c_int,  # blocks, threads
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _require_gather_operands(table: torch.Tensor, ids: torch.Tensor) -> None:
    """What every gather kernel takes: a contiguous float32 CUDA table,
    16-byte aligned, and contiguous int32 ids beside it."""
    _cuda.require_cuda(table, "table", torch.float32)
    _cuda.require_cuda(ids, "ids", torch.int32)
    if table.device != ids.device:
        raise ValueError("table and ids must be on the same device")
    if table.data_ptr() % 16 != 0:
        raise ValueError("a gather needs a 16-byte aligned table")


def _launch_k2(tables, ids, want: Tuple[bool, ...], windows):
    """One launch of kernel K2: (x [*ids.shape, sum D], flat int32
    [fields wanted, L*B] or None)."""
    for t, i in zip(tables, ids):
        _require_gather_operands(t, i)
        if t.device != ids[0].device or i.shape != ids[0].shape:
            raise ValueError("every field's ids must have one shape, on one device")
    plan = field_plan([t.shape for t in tables], tuple(ids[0].shape))
    dev = ids[0].device
    x = torch.empty((*ids[0].shape, sum(plan.widths)), dtype=torch.float32, device=dev)
    flat = (torch.empty((sum(want), plan.rows), dtype=torch.int32, device=dev)
            if any(want) else None)
    if plan.rows == 0:
        return x, flat
    c = _GatherPlan(n_fields=len(tables), batch=plan.batch, rows=plan.rows,
                    out_d4=sum(plan.widths) // 4)
    k = 0
    for f, (t, i, w, (lo, mode)) in enumerate(zip(tables, ids, want, windows)):
        if not -2**31 <= lo < 2**31:
            raise ValueError(f"row_lo {lo} is past int32")
        c.field[f] = _Field(t.data_ptr(), i.data_ptr(), flat[k].data_ptr() if w else None,
                            plan.n_rows[f], plan.lane_strides[f], plan.widths[f] // 4,
                            plan.offsets[f] // 4, lo, mode)
        k += w
    _cuda.check(_bind()(ctypes.byref(c), plan.blocks, plan.threads, x.data_ptr(),
                        _cuda.stream_ptr(dev)), "gather_fields")
    gather_fields.launches += 1
    gather_fields.lane_launches += ids[0].dim() == 2
    gather_fields.window_launches += any(m != CLAMP for _, m in windows)
    return x, flat


class _GatherFields(torch.autograd.Function):
    """K2 with a gradient for the tables that require one: ``scatter_rows``
    of each such field's column slice of dx at the clamped flat row ids."""

    @staticmethod
    def forward(ctx, want, windows, *operands):
        n = len(operands) // 2
        tables, ids = operands[:n], operands[n:]
        x, flat = _launch_k2(tables, ids, want, windows)
        ctx.want, ctx.shapes = want, [t.shape for t in tables]
        ctx.save_for_backward(flat)
        ctx.mark_non_differentiable(flat)
        return x, flat

    @staticmethod
    def backward(ctx, gx, _gflat):
        (flat,) = ctx.saved_tensors
        grads, k, off = [], 0, 0
        for f, (shape, w) in enumerate(zip(ctx.shapes, ctx.want)):
            d = shape[-1]
            grads.append(scatter_rows(shape, flat[k], gx[..., off:off + d])
                         if ctx.needs_input_grad[2 + f] else None)
            k, off = k + w, off + d
        return (None, None, *grads, *(None,) * len(grads))


def gather_fields(tables: Sequence[torch.Tensor], ids: Sequence[torch.Tensor],
                  train_mask: Optional[Sequence[bool]] = None, windows=None):
    """Gather every field's rows into one output: the tower input.

    ``tables[f]`` float32 [N_f, D_f] (one tower, or a table every lane
    reads) or [L, N_f, D_f] (a table a lane); ``ids[f]`` int32, all of one
    shape, [B] or [L, B]; at most four fields. Returns (x [*ids.shape,
    sum D_f], flats): x[..., off_f : off_f + D_f] is field f's rows with ids
    clamped to the lane's table, and ``flats[f]`` is int32 [L*B], the flat
    row ids read (``table_rows``' second result), for the fields
    ``train_mask`` marks, else None.

    CUDA tensors go through kernel K2: one launch, counted in
    ``gather_fields.launches`` (and in ``gather_fields.lane_launches`` too
    when the ids are [L, B]), differentiable in the tables that require a
    gradient. A CUDA call the kernel does not take raises. CPU tensors run
    the plain version.

    ``windows[f]``, None or (row_lo, mode), reads field f as a row shard
    (``table_rows``: ``WINDOW`` zeros outside it, ``SILENT`` zeros with the
    clamped row ids); a call with a window other than the clamp is also
    counted in ``gather_fields.window_launches``.

    Either route is the span ``k2.gather``.
    """
    tables, ids = tuple(tables), tuple(ids)
    with trace.span("k2.gather"):
        mask = _mask(train_mask, len(tables))
        if len(ids) != len(tables):
            raise ValueError(f"{len(tables)} tables and {len(ids)} id tensors")
        win = _windows(windows, len(tables))
        if all(t.device.type == "cpu" for t in (*tables, *ids)):
            return gather_fields_reference(tables, ids, mask, win)
        grad = torch.is_grad_enabled() and any(t.requires_grad for t in tables)
        want = tuple(m or (grad and t.requires_grad) for m, t in zip(mask, tables))
        x, flat = (_GatherFields.apply(want, win, *tables, *ids) if grad
                   else _launch_k2(tables, ids, want, win))
        flats, k = [], 0
        for w, m in zip(want, mask):  # flat holds a row for each wanted field
            flats.append(flat[k] if m else None)
            k += w
        return x, tuple(flats)


gather_fields.launches = 0
gather_fields.lane_launches = 0
gather_fields.window_launches = 0


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Gather rows: table [N, D] float32, ids [B] int32 -> [B, D], ids clamped.

    The one-field case of ``gather_fields``: CUDA tensors go through kernel
    K2 (one launch, counted in ``gather_fields.launches``), CPU tensors
    through the plain version.
    """
    return gather_fields((table,), (ids,))[0]


RING_SHARED_BYTES_MAX = 232448  # 227 KB: the most shared memory a block may opt into
RING_BLOCKS_PER_SM = 4          # measured on an H100: 1 a SM leaves 30720 ids at 24 us, 4 at 11


class RingPlan(NamedTuple):
    """How kernel K3 deals a lookup over the card (see ``ring_plan``)."""
    blocks: int          # grid size
    rows_per_block: int  # consecutive rows a block owns
    slots: int           # one-row slots of a block's ring: its depth in flight
    shared_bytes: int    # of a block: the slots and one 8-byte mbarrier each


def ring_plan(batch: int, k: int, dim: int, sm_count: int) -> RingPlan:
    """Kernel K3's launch for ``batch`` ids, depth ``k`` and ``dim`` float32 a
    row on a card of ``sm_count`` SMs: about ``RING_BLOCKS_PER_SM`` blocks per
    SM, a block owning ``ceil(batch / (4 * sm_count))`` consecutive rows and a
    ring of ``min(k, its rows)`` slots. Raises ``ValueError`` for a row whose byte
    length is no multiple of 16 (a bulk copy's unit) and for a ring that does
    not fit a block's 227 KB of shared memory."""
    if batch < 1 or k < 1 or sm_count < 1:
        raise ValueError(f"ring_plan needs batch, k, sm_count >= 1, got {batch}, {k}, {sm_count}")
    if (dim * 4) % 16 != 0:
        raise ValueError(f"a row of {dim} float32 is {dim * 4} bytes, not a multiple of 16")
    rows_per_block = -(-batch // (RING_BLOCKS_PER_SM * sm_count))
    blocks = -(-batch // rows_per_block)
    slots = min(k, rows_per_block)
    shared = slots * (dim * 4 + 8)
    if shared > RING_SHARED_BYTES_MAX:
        raise ValueError(
            f"a ring of {slots} rows of {dim} float32 needs {shared} bytes of shared "
            f"memory, more than a block's {RING_SHARED_BYTES_MAX}")
    return RingPlan(blocks, rows_per_block, slots, shared)


@functools.lru_cache(maxsize=None)
def _bind_pipelined():
    fn = _cuda.load("gather_rows_pipelined").mamdr_gather_rows_pipelined
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # n_rows, dim, batch
        ctypes.c_int, ctypes.c_int,                # rows a block, slots
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def gather_rows_pipelined(table: torch.Tensor, ids: torch.Tensor, k: int = 32) -> torch.Tensor:
    """Gather rows through rings of row copies in flight: table [N, D]
    float32, ids [B] int32 -> [B, D], with ``k = min(k, B)``.

    The same function as ``embedding_lookup``. The Pallas kernel it replaces
    runs one ring of ``k`` copies on one TPU core; kernel K3 deals the rows
    over the card's SMs (``ring_plan``: a few blocks per SM, each owning a
    run of consecutive rows), and ``k`` is the depth in flight PER BLOCK: a
    block's ring has ``min(k, its rows)`` slots, each filled and drained by
    the copy engine (``cp.async.bulk`` on an ``mbarrier``). Unlike the Pallas
    kernel, which does not clip (an out-of-range id is an out-of-bounds DMA
    there), it clamps ids as ``embedding_lookup`` does. CUDA tensors go
    through kernel K3 (one launch, counted in
    ``gather_rows_pipelined.launches``); a ring that does not fit a block's
    227 KB of shared memory raises. CPU tensors go through the plain version,
    where ``k`` changes nothing.
    """
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")
    if table.device.type == "cpu" and ids.device.type == "cpu":
        return embedding_lookup_reference(table, ids)
    _require_gather_operands(table, ids)
    if table.dim() != 2 or ids.dim() != 1 or table.shape[0] == 0:
        raise ValueError(f"table must be [N>=1, D] and ids [B], got {table.shape}, {ids.shape}")
    (n, d), b = table.shape, ids.shape[0]
    out = torch.empty((b, d), dtype=table.dtype, device=table.device)
    if b == 0:
        return out
    plan = ring_plan(b, min(int(k), b), d, _cuda.sm_count(table.device))
    rc = _bind_pipelined()(table.data_ptr(), ids.data_ptr(), out.data_ptr(), n, d, b,
                           plan.rows_per_block, plan.slots, _cuda.stream_ptr(table.device))
    _cuda.check(rc, "gather_rows_pipelined")
    gather_rows_pipelined.launches += 1
    return out


gather_rows_pipelined.launches = 0

trace.register(lambda: {"k2.launches": gather_fields.launches,
                        "k2.lane_launches": gather_fields.lane_launches,
                        "k2.window_launches": gather_fields.window_launches,
                        "k3.launches": gather_rows_pipelined.launches})
