"""Sparse-feature embedding blocks: uid / pid / domain tables.

Counterpart of ``mamdr_tpu/models/embeddings.py``: ``EmbeddingBlock``, three
tables, the user and item ones optionally pretrained (reference
model_zoo/DeepCTR/deepctr.py:95-116), gathered by one field gather (kernel
K2 on the card); ``LinearEmbeddingBlock``, the dim-1 tables of the wide
term, ``linear_{user,item,domain}_emb`` [N, 1], gathered by plain indexing
(``table_rows``: K2 takes widths that are multiples of 4, and the JAX
package gathers these with ``jnp.take``, not a Pallas kernel); and
``stack_fields``, the [B, 3, D] field stack as a view of the gather's one
output.

The table rule lives here alone; callers build its masks once, never per
step. Tables (the l2 term's set) are the paths holding "emb"; with
``emb_trainable`` false those holding "user_emb" or "item_emb" are frozen,
the wide term's too, as in the JAX package; and a mesh row-shards by the
JAX package's rule or, narrower, by its lookup's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from mamdr_tpu_torch.models.layers import emb_init
from mamdr_tpu_torch.ops.embedding_lookup import table_rows
from mamdr_tpu_torch.utils import trees

FIELD_TABLES = ("user_emb", "item_emb", "domain_emb")  # the field gather's, in order


def _user_or_item(name: str) -> bool:
    return "user_emb" in name or "item_emb" in name


def table_mask(params):
    """True at the tables: each leaf whose path holds "emb"."""
    return trees.named_tree_map(lambda n, x: "emb" in n, params)


def frozen_mask(params, emb_trainable: bool):
    """True at the tables the optimizer never trains."""
    return trees.named_tree_map(lambda n, x: not emb_trainable and _user_or_item(n), params)


def jax_row_sharded(name: str, x: torch.Tensor) -> bool:
    """The JAX package's row-shard rule: a 2-D user or item table, [n, 1]
    ones too (the caller checks the rows divide the table axis)."""
    return _user_or_item(name) and x.dim() == 2


def lookup_row_sharded(name: str) -> bool:
    """The mesh lookup's: a leaf named exactly ``user_emb`` / ``item_emb``."""
    return name.rsplit("/", 1)[-1] in FIELD_TABLES[:2]


def _table(pretrained: Optional[np.ndarray], shape, generator) -> nn.Parameter:
    if pretrained is not None:
        if tuple(pretrained.shape) != tuple(shape):
            raise ValueError(f"pretrained shape {pretrained.shape} != {shape}")
        # shares the caller's buffer: parameters are never written in place
        return nn.Parameter(torch.from_numpy(np.asarray(pretrained, np.float32)))
    return nn.Parameter(emb_init(torch.empty(shape), generator))


class EmbeddingBlock(nn.Module):
    """The three field tables; a model gathers them into x [B, user_dim +
    item_dim + domain_dim], the concatenated (u, p, d) rows, by one field
    gather (kernel K2 on the card, differentiable in the tables;
    ``ZooModel.gather_inputs``)."""

    def __init__(self, n_uid: int, n_pid: int, n_domain: int,
                 user_dim: int, item_dim: int, domain_dim: int,
                 pretrained_user: Optional[np.ndarray] = None,
                 pretrained_item: Optional[np.ndarray] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.user_emb = _table(pretrained_user, (n_uid, user_dim), generator)
        self.item_emb = _table(pretrained_item, (n_pid, item_dim), generator)
        self.domain_emb = _table(None, (n_domain, domain_dim), generator)


class LinearEmbeddingBlock(nn.Module):
    """Dim-1 tables for the linear ("wide") term of WDL / DeepFM / NFM /
    AutoInt / CCPM: ``linear_{user,item,domain}_emb`` [N, 1], drawn N(0,
    1e-4) as the JAX package draws them; ``linear_logit`` reads them."""

    def __init__(self, n_uid: int, n_pid: int, n_domain: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.linear_user_emb = _table(None, (n_uid, 1), generator)
        self.linear_item_emb = _table(None, (n_pid, 1), generator)
        self.linear_domain_emb = _table(None, (n_domain, 1), generator)


def linear_logit(tables, uid, pid, domain) -> torch.Tensor:
    """The wide term: the three dim-1 rows summed in the JAX package's order
    -> [*ids.shape]. ``tables`` holds the ``linear_*_emb`` leaves, each
    [N, 1] (one tower, or read by every lane) or [L, N, 1] (a lane's own;
    ids [L, B])."""
    out = (table_rows(tables["linear_user_emb"], uid)[0]
           + table_rows(tables["linear_item_emb"], pid)[0]
           + table_rows(tables["linear_domain_emb"], domain)[0])
    return out[..., 0]


def stack_fields(x: torch.Tensor, dims) -> torch.Tensor:
    """The field stack [..., 3, D] as a view of the gather's output x
    [..., 3 * D]; the fields must have one width (true of every shipped
    config)."""
    if len(set(dims)) != 1:
        raise ValueError("field-interaction models require user_dim == item_dim == "
                         f"domain_dim, got {tuple(dims)}")
    return x.unflatten(-1, (len(dims), dims[0]))
