"""Probe of the embedding gather's cost on the card; the path that runs K3.

    python3 -m mamdr_tpu_torch.probe_gather

Counterpart of ``scripts/probe_gather.py``. On one CUDA card, from the
repository root, at the bench workload's lookups into a [100000, 128]
float32 table — a step's 1024 ids, and a lane-step's 30720 (four id sets
taken in turn, so that a replay does not find its rows in L2) — it times by
CUDA-graph replay

  - kernel K2's one-field case, ``embedding_lookup`` (one warp per row);
  - kernel K3, ``gather_rows_pipelined``, at k 32 and k 128 (rings of bulk
    row copies dealt over the card's SMs, k deep in each block: does depth in
    flight, or handing the copies to the copy engine, buy anything over K2?);
    its launch plan is printed beside its time. At 1024 ids a block owns
    fewer rows than either k, so both depths plan the same launch and no ring
    turns; at 30720 ids a block's ring of 32 turns and one of 128 does not;
  - the plain version (PyTorch advanced indexing);
  - ``torch.nn.functional.embedding``, a yardstick the port calls nowhere else;
  - the contiguous-slice floor: a slice copy of as many rows, no gather at all;
  - kernel K2 as the train step calls it, ``gather_fields`` of three 128-d
    fields (two [100000, 128] tables and a domain table of 30 rows, one
    domain a batch, lane-stacked at 30 lanes) into x [ids, 384], beside its
    floor: a contiguous copy of x's bytes, [ids, 384] out of a [100000, 384]
    array, no gather at all (it reads at least the bytes the gather reads);

checks that every gather agrees exactly with the plain version, and prints
ns per output row with the card's name and power limit on every line. It
raises without a card. The XLA-specific variants of the JAX script (bf16
table, one-hot matmul, combined 200k table) are not kernels and are left out.

    python3 -m mamdr_tpu_torch.probe_gather --sweep

times kernel K3 under other launch plans than ``ring_plan``'s — 1 to 8 blocks
per SM at both sizes, and builds of the kernel with 1 and 32 issuing threads
a block beside its own 128 — which is how the plan's four blocks per SM and
the kernel's 128 threads were chosen.
"""

from __future__ import annotations

import sys
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from mamdr_tpu_torch import resolve_device
from mamdr_tpu_torch.ops import _cuda
from mamdr_tpu_torch.ops.embedding_lookup import (
    _bind_pipelined,
    embedding_lookup,
    embedding_lookup_reference,
    gather_fields,
    gather_fields_reference,
    gather_rows_pipelined,
    ring_plan,
)
from mamdr_tpu_torch.utils.timing import card_line, device_ms

B, N_ROWS, DIM = 1024, 100_000, 128
LANES = 30               # the lane-step's lookup is LANES * B ids
N_DOMAINS = 30           # rows of the domain table
FIELDS = 3               # user, item, domain: x is [ids, FIELDS * DIM]
RING_DEPTHS = (32, 128)  # scripts/probe_gather.py:100-103
ID_SETS = 4


class Row(NamedTuple):
    """One timed variant of ``run``."""
    name: str
    ids: int             # ids a call gathers
    k: Optional[int]     # K3's ring depth; None for every other variant
    ns_per_row: float    # per output row
    k3_launches: int     # calls of K3's wrapper this variant made (0 unless K3)
    row_bytes: int = DIM * 4  # of an output row


def run(seed: int = 0, inner: int = 48, verbose: bool = True) -> List[Row]:
    """Time every variant at both sizes."""
    dev = resolve_device(None)  # the card, or raise
    card = card_line()
    sms = _cuda.sm_count(dev)
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.normal(0, 0.1, (N_ROWS, DIM)).astype(np.float32)).to(dev)
    item = torch.from_numpy(rng.normal(0, 0.1, (N_ROWS, DIM)).astype(np.float32)).to(dev)
    wide = torch.from_numpy(rng.normal(0, 0.1, (N_ROWS, FIELDS * DIM)).astype(np.float32)).to(dev)
    rows = []
    for b in (B, LANES * B):
        n_sets = 1 if b == B else ID_SETS
        id_sets = [torch.from_numpy(rng.integers(0, N_ROWS, b).astype(np.int32)).to(dev)
                   for _ in range(n_sets)]
        long_sets = [i.long() for i in id_sets]
        offset = int(rng.integers(0, N_ROWS - b))
        want = embedding_lookup_reference(table, id_sets[0])
        turn = [0]

        def in_turn(fn, sets):
            turn[0] += 1
            return fn(sets[turn[0] % len(sets)])

        variants = [
            ("K2 gather_fields, one field", None,
             lambda i: embedding_lookup(table, i), id_sets),
            *[(f"K3 gather_rows_pipelined k={k}", k,
               lambda i, k=k: gather_rows_pipelined(table, i, k=k), id_sets)
              for k in RING_DEPTHS],
            ("plain version (table[ids])", None,
             lambda i: embedding_lookup_reference(table, i), id_sets),
            ("F.embedding (yardstick)", None,
             lambda i: torch.nn.functional.embedding(i, table), long_sets),
        ]
        for name, k, fn, sets in variants:
            before = gather_rows_pipelined.launches
            if not torch.equal(fn(sets[0]), want):
                raise RuntimeError(f"probe_gather: {name} differs from the plain gather")
            ms = device_ms(lambda: in_turn(fn, sets), inner=inner)
            rows.append(Row(name, b, k, ms * 1e6 / b, gather_rows_pipelined.launches - before))
        rows.append(Row(f"contiguous slice copy [{b},{DIM}]", b, None,
                        device_ms(lambda: table[offset : offset + b].clone(), inner=inner)
                        * 1e6 / b, 0))
        rows += _fields_vs_copy(rng, dev, (table, item), wide, offset, b, inner)
        if verbose:
            for k in RING_DEPTHS:
                plan = ring_plan(b, k, DIM, sms)
                print(f"K3 k={k}, {b} ids: {plan.blocks} blocks, {plan.rows_per_block} rows and "
                      f"a ring of {plan.slots} slots a block, {plan.shared_bytes} bytes of "
                      f"shared memory")
            for r in rows:
                if r.ids == b:
                    print(f"{r.name:34s} {b:5d} ids: {r.ns_per_row * b / 1e3:7.2f} us/call, "
                          f"{r.ns_per_row:6.2f} ns/row ({r.row_bytes / r.ns_per_row:6.1f} GB/s "
                          f"of output); {card}")
    return rows


def _fields_vs_copy(rng, dev, tables, wide, offset, b, inner) -> List[Row]:
    """K2's three-field call at ``b`` ids (the DN step's at 1024, the DR
    lane-step's at 30 x 1024, four id sets in turn) and a contiguous copy of
    its output's bytes, timed in the order K2, copy, copy, K2."""
    lanes = 1 if b == B else LANES
    shape = (b,) if lanes == 1 else (lanes, B)
    dom = torch.from_numpy(rng.normal(0, 0.1, shape[:-1] + (N_DOMAINS, DIM))
                           .astype(np.float32)).to(dev)
    ids = lambda n, s: torch.from_numpy(  # noqa: E731
        rng.integers(0, n, s).astype(np.int32)).to(dev)
    sets = [(ids(N_ROWS, shape), ids(N_ROWS, shape),
             ids(N_DOMAINS, shape[:-1] + (1,)).expand(shape).contiguous())
            for _ in range(ID_SETS)]
    fields = (*tables, dom)
    if not torch.equal(gather_fields(fields, sets[0])[0],
                       gather_fields_reference(fields, sets[0])[0]):
        raise RuntimeError("probe_gather: K2's three-field call differs from the plain version")
    turn = [0]

    def k2():
        turn[0] += 1
        return gather_fields(fields, sets[turn[0] % len(sets)], train_mask=(False, False, True))

    def copy():
        return wide[offset : offset + b].clone()

    us = {"k2": [], "copy": []}
    for name in ("k2", "copy", "copy", "k2"):
        us[name].append(device_ms(k2 if name == "k2" else copy, inner=inner) * 1e3)
    return [Row(f"K2 gather_fields, {FIELDS} fields, #{n + 1}", b, None, us["k2"][n] * 1e3 / b,
                0, FIELDS * DIM * 4) for n in range(2)] + [
            Row(f"contiguous copy [{b},{FIELDS * DIM}] #{n + 1}", b, None,
                us["copy"][n] * 1e3 / b, 0, FIELDS * DIM * 4) for n in range(2)]


def sweep(seed: int = 0, inner: int = 48) -> None:
    """Time K3's kernel under plans of 1, 2, 4 and 8 blocks per SM, in builds
    with 1, 32 and 128 issuing threads a block, k 32 and 128, at 1024 and
    30720 ids (four id sets in turn)."""
    dev = resolve_device(None)
    card = card_line()
    sms = _cuda.sm_count(dev)
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.normal(0, 0.1, (N_ROWS, DIM)).astype(np.float32)).to(dev)
    try:
        for issuers in (1, 32, 128):
            _cuda.build_variant([f"-DMAMDR_K3_ISSUERS={issuers}"])
            _bind_pipelined.cache_clear()
            kernel = _bind_pipelined()
            for b in (B, LANES * B):
                id_sets = [torch.from_numpy(rng.integers(0, N_ROWS, b).astype(np.int32)).to(dev)
                           for _ in range(ID_SETS)]
                out = torch.empty((b, DIM), dtype=torch.float32, device=dev)
                turn = [0]

                def launch(rows_per_block, slots):
                    turn[0] += 1
                    ids = id_sets[turn[0] % len(id_sets)]
                    _cuda.check(kernel(table.data_ptr(), ids.data_ptr(), out.data_ptr(), N_ROWS,
                                       DIM, b, rows_per_block, slots, _cuda.stream_ptr(dev)),
                                "gather_rows_pipelined")

                for per_sm in (1, 2, 4, 8):
                    rows_per_block = -(-b // (per_sm * sms))
                    for k in RING_DEPTHS:
                        slots = min(k, rows_per_block)
                        us = device_ms(lambda: launch(rows_per_block, slots), inner=inner) * 1e3
                        print(f"K3 {b:5d} ids, {per_sm} blocks an SM ({rows_per_block:3d} rows "
                              f"a block), ring of {slots:3d}, {issuers:3d} issuing threads: "
                              f"{us:6.2f} us/call; {card}")
    finally:
        _cuda.build_variant(())
        _bind_pipelined.cache_clear()


if __name__ == "__main__":
    if "--sweep" in sys.argv[1:]:
        sweep()
    else:
        run()
    sys.exit(0)
