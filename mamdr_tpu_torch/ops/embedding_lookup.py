"""Embedding lookup: gather table rows with clip semantics.

Counterpart of ``mamdr_tpu/ops/embedding_lookup.py::embedding_lookup``
(``jnp.take(..., mode="clip")``: out-of-range ids are clamped, as TF does).
On a CUDA tensor it launches the port's row-gather kernel
(``csrc/gather_rows.cu``, kernel K2), which replaces the Pallas row gather
``pallas_gather_rows`` (``mamdr_tpu/ops/embedding_lookup.py:56``) and adds
the clamp inside the kernel. On a CPU tensor it runs the plain version.
"""

from __future__ import annotations

import ctypes
import functools

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


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Gather rows: table [N, D] float32, ids [B] int32 -> [B, D].

    CUDA tensors go through kernel K2 (one launch, counted in
    ``embedding_lookup.launches``); CPU tensors through the plain version.
    """
    if table.device.type == "cpu" and ids.device.type == "cpu":
        return embedding_lookup_reference(table, ids)
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
    b = ids.shape[0]
    out = torch.empty((b, d), dtype=table.dtype, device=table.device)
    if b == 0:
        return out
    rc = _bind()(table.data_ptr(), ids.data_ptr(), out.data_ptr(), n, d, b,
            _cuda.stream_ptr(table.device))
    _cuda.check(rc, "gather_rows")
    embedding_lookup.launches += 1
    return out


embedding_lookup.launches = 0
