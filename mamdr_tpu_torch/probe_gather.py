"""Probe of the embedding gather's cost on the card; the path that runs K3.

    python3 -m mamdr_tpu_torch.probe_gather

Counterpart of ``scripts/probe_gather.py``. On one CUDA card, from the
repository root, at the bench workload's lookup (1024 ids into a
[100000, 128] float32 table), it times by CUDA-graph replay

  - kernel K2, ``embedding_lookup`` (one warp per row);
  - kernel K3, ``gather_rows_pipelined``, at k 32 and k 128 (a ring of k row
    copies in flight: does depth in flight buy anything over K2?);
  - the plain version (PyTorch advanced indexing);
  - ``torch.nn.functional.embedding``, a yardstick the port calls nowhere else;
  - the contiguous-slice floor: a [1024, 128] slice copy, no gather at all;

checks that every gather agrees exactly with the plain version, and prints
ns per gathered row with the card's name and power limit on every line. It
raises without a card. The XLA-specific variants of the JAX script (bf16
table, one-hot matmul, combined 200k table) are not kernels and are left out.
"""

from __future__ import annotations

import sys
from typing import List, Tuple

import numpy as np
import torch

from mamdr_tpu_torch import resolve_device
from mamdr_tpu_torch.ops.embedding_lookup import (
    embedding_lookup,
    embedding_lookup_reference,
    gather_rows_pipelined,
)
from mamdr_tpu_torch.utils.timing import card_line, device_ms

B, N_ROWS, DIM = 1024, 100_000, 128
RING_DEPTHS = (32, 128)  # scripts/probe_gather.py:100-103


def run(seed: int = 0, inner: int = 50, verbose: bool = True) -> List[Tuple[str, float]]:
    """Time every variant; returns [(name, ns per row)]."""
    dev = resolve_device(None)  # the card, or raise
    card = card_line()
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.normal(0, 0.1, (N_ROWS, DIM)).astype(np.float32)).to(dev)
    ids = torch.from_numpy(rng.integers(0, N_ROWS, B).astype(np.int32)).to(dev)
    ids_long = ids.long()
    offset = int(rng.integers(0, N_ROWS - B))
    want = embedding_lookup_reference(table, ids)

    variants = [
        ("K2 gather_rows (warp per row)", lambda: embedding_lookup(table, ids)),
        *[(f"K3 gather_rows_pipelined k={k}",
           lambda k=k: gather_rows_pipelined(table, ids, k=k)) for k in RING_DEPTHS],
        ("plain version (table[ids])", lambda: embedding_lookup_reference(table, ids)),
        ("F.embedding (yardstick)", lambda: torch.nn.functional.embedding(ids_long, table)),
    ]
    rows = []
    for name, fn in variants:
        if not torch.equal(fn(), want):
            raise RuntimeError(f"probe_gather: {name} differs from the plain gather")
        rows.append((name, device_ms(fn, inner=inner) * 1e6 / B))
    rows.append(("contiguous slice copy [1024,128]",
                 device_ms(lambda: table[offset : offset + B].clone(), inner=inner)
                 * 1e6 / B))
    if verbose:
        for name, ns in rows:
            print(f"{name:34s}: {ns * B / 1e3:7.2f} us/call, {ns:6.2f} ns/row "
                  f"({DIM * 4 / ns:6.1f} GB/s of rows); {card}")
    return rows


if __name__ == "__main__":
    run()
    sys.exit(0)
