"""Embedding lookup: gather table rows with clip semantics.

Counterpart of ``mamdr_tpu/ops/embedding_lookup.py::embedding_lookup``
(``jnp.take(..., mode="clip")``: out-of-range ids are clamped, as TF does).
On a CUDA tensor it launches the port's row-gather kernel
(``csrc/gather_rows.cu``, kernel K2), which replaces the Pallas row gather
``pallas_gather_rows`` (``mamdr_tpu/ops/embedding_lookup.py:56``) and adds
the clamp inside the kernel. On a CPU tensor it runs the plain version.

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
from typing import NamedTuple

import torch

from mamdr_tpu_torch.ops import _cuda


def embedding_lookup_reference(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: table [N, D], ids [B] -> [B, D], ids clamped."""
    return table[ids.long().clamp(0, table.shape[0] - 1)]


@functools.lru_cache(maxsize=None)
def _bind():
    """The kernel entry of the built library, bound once."""
    fn = _cuda.load("gather_rows").mamdr_gather_rows
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _require_gather_operands(table: torch.Tensor, ids: torch.Tensor) -> None:
    """What both gather kernels take: a contiguous float32 CUDA table [N>=1, D]
    with D % 4 == 0, 16-byte aligned, and contiguous int32 ids [B] beside it."""
    _cuda.require_cuda(table, "table", torch.float32)
    _cuda.require_cuda(ids, "ids", torch.int32)
    if table.device != ids.device:
        raise ValueError("table and ids must be on the same device")
    if table.dim() != 2 or ids.dim() != 1:
        raise ValueError(f"table must be [N, D] and ids [B], got {table.shape}, {ids.shape}")
    n, d = table.shape
    if d % 4 != 0 or table.data_ptr() % 16 != 0:
        raise ValueError("gather_rows needs D % 4 == 0 and a 16-byte aligned table")
    if n == 0:
        raise ValueError("empty table")


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Gather rows: table [N, D] float32, ids [B] int32 -> [B, D].

    CUDA tensors go through kernel K2 (one launch, counted in
    ``embedding_lookup.launches``); CPU tensors through the plain version.
    """
    if table.device.type == "cpu" and ids.device.type == "cpu":
        return embedding_lookup_reference(table, ids)
    _require_gather_operands(table, ids)
    (n, d), b = table.shape, ids.shape[0]
    out = torch.empty((b, d), dtype=table.dtype, device=table.device)
    if b == 0:
        return out
    rc = _bind()(table.data_ptr(), ids.data_ptr(), out.data_ptr(), n, d, b,
            _cuda.stream_ptr(table.device))
    _cuda.check(rc, "gather_rows")
    embedding_lookup.launches += 1
    return out


embedding_lookup.launches = 0


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
