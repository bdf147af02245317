"""Each data rank's rows of a batch.

Counterpart of ``mamdr_tpu/parallel/data_feed.py``: there each host loads
its own contiguous slice of a global batch and JAX assembles the sharded
array. Here a data rank keeps its rows on its own device; the ranks of one
table group (the same data index) hold the same rows.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from mamdr_tpu_torch.parallel.mesh import Mesh


def process_local_rows(n_global: int, index: int, count: int) -> slice:
    """The rows of block ``index`` of ``count`` in a batch of ``n_global``
    rows: contiguous blocks of ``n_global // count``, the last one taking
    the remainder (JAX ``process_local_rows``, data_feed.py:37-44, by
    process index; here by data index, ``data_rows``)."""
    per = n_global // count
    start = index * per
    return slice(start, n_global if index == count - 1 else start + per)


def data_rows(mesh: Mesh, n_global: int) -> slice:
    """This data rank's rows of an ``n_global``-row batch; the data axis must
    divide it, as the JAX package's ``shard_map`` over P(data) requires."""
    if n_global % mesh.data != 0:
        raise ValueError(f"a batch of {n_global} rows does not divide the mesh data "
                         f"axis {mesh.data}")
    return process_local_rows(n_global, mesh.data_index, mesh.data)


def shard_host_batch(mesh: Mesh, host_batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """{column: [B]} of the whole batch -> this data rank's rows of each, on
    its device (``data_rows``)."""
    out = {}
    for k, v in host_batch.items():
        v = np.asarray(v)
        out[k] = torch.from_numpy(np.ascontiguousarray(v[data_rows(mesh, v.shape[0])])).to(
            mesh.device)
    return out
