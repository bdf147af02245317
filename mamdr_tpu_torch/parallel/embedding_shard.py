"""Row-sharded embedding lookups over the (data, table) mesh.

Counterpart of ``mamdr_tpu/parallel/embedding_shard.py``. Each rank of a
table group holds a contiguous row range of a table, rows [t * n, (t + 1) *
n) at table index t, and the lookup is a masked local gather followed by
one ``all_reduce`` over the table group: a rank contributes a row only if
the id falls in its range, zeros otherwise, so the collective moves [B, D],
never the table.

The local gather is kernel K2 (``ops/embedding_lookup.py::gather_fields``)
with a row window on the field (``WINDOW``): an id outside [0, padded
rows) reads zeros, as ``jax.shard_map``'s masked gather gives
(embedding_shard.py:33-37), where the plain lookup clamps it. The model's
three fields stay ONE K2 launch and ONE ``all_reduce`` of x [B, 3D] a step
(``MeshLookup``): a row-sharded user or item field reads its window, and a
replicated field (the domain table, and a table below
``sharded_lookup_min_rows``) is read with the clamp by table index 0 and
``SILENT`` by the others — zeros into x, so the sum holds one copy, with
the clamped row ids all the same, so the gradient is whole on every rank.

The backward holds no collective: every member of a table group computes
the same downstream gradient (the same x after the sum, the same replicated
tower, the same rows), so a rank's shard gradient is the scatter-add of dx
at its own rows (K2's flat ids; a row outside the shard goes to a spare row
that is dropped). The train step sums table-shard gradients over the data
group (parallel/trainer_sharding.py).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from mamdr_tpu_torch.ops.embedding_lookup import CLAMP, SILENT, WINDOW, gather_fields
from mamdr_tpu_torch.parallel.mesh import TABLE_AXIS, Mesh, all_reduce_sum_, table_sum


def pad_rows(n_rows: int, table_parallelism: int) -> int:
    """Rows after padding to a multiple of the table-axis size."""
    return -(-n_rows // table_parallelism) * table_parallelism


def shard_range(mesh: Mesh, n_rows: int) -> slice:
    """This rank's rows of a table of ``n_rows`` (a multiple of the table
    axis) that is row-sharded over its table group."""
    if n_rows % mesh.table != 0:
        raise ValueError(f"{n_rows} rows do not divide the table axis {mesh.table}")
    per = n_rows // mesh.table
    return slice(mesh.table_index * per, (mesh.table_index + 1) * per)


def sharded_lookup(mesh: Mesh, table_shard: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table_shard: this rank's rows of a row-sharded table [n / table, D];
    ids [B] global row ids -> [B, D] rows, zeros for an id no shard holds.
    One K2 launch with the window, then one ``all_reduce`` over the table
    group; differentiable in the shard."""
    lo = mesh.table_index * table_shard.shape[0]
    x = gather_fields((table_shard,), (ids,), windows=((lo, WINDOW),))[0]
    return _table_total(mesh, x)


def _table_total(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The gathered x summed over the table group: in x's own buffer where
    no gradient flows through it, else ``table_sum``."""
    return table_sum(mesh, x) if x.requires_grad else all_reduce_sum_(mesh, x, TABLE_AXIS)


class MeshLookup:
    """The field gather of a model on a mesh, a drop-in for
    ``gather_fields`` wherever a model gathers its (user, item, domain)
    fields: ``sharded[f]`` says whether field f's table is row-sharded.
    Returns (x summed over the table group, the flat row ids of the fields
    ``train_mask`` marks); tables [n, D] or lane-stacked [L, n, D], ids [B]
    or [L, B]."""

    def __init__(self, mesh: Mesh, sharded: Sequence[bool]):
        self.mesh = mesh
        self.sharded = tuple(bool(s) for s in sharded)
        self.sharded_names = frozenset(
            n for n, s in zip(("user_emb", "item_emb", "domain_emb"), self.sharded) if s)

    def windows(self, tables) -> Tuple[Tuple[int, int], ...]:
        first = self.mesh.table_index == 0
        return tuple((self.mesh.table_index * t.shape[-2], WINDOW) if s
                     else (0, CLAMP if first else SILENT)
                     for t, s in zip(tables, self.sharded))

    def __call__(self, tables, ids, train_mask: Optional[Sequence[bool]] = None):
        if len(tables) != len(self.sharded):
            raise ValueError(f"a mesh lookup of {len(self.sharded)} fields got {len(tables)}")
        x, flats = gather_fields(tables, ids, train_mask, windows=self.windows(tables))
        return _table_total(self.mesh, x), flats

    def sharded_leaf(self, name: str) -> bool:
        """Whether the param leaf ``name`` is one of the row-sharded tables."""
        return name.rsplit("/", 1)[-1] in self.sharded_names
