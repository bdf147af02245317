"""Sparse-feature embedding block: uid / pid / domain tables.

Counterpart of ``mamdr_tpu/models/embeddings.py::EmbeddingBlock``: three
tables, the user and item ones optionally pretrained (reference
model_zoo/DeepCTR/deepctr.py:95-116). Freezing is not done here; the
optimizer skips frozen tables (train/steps.py::make_optimizer). Paths all
contain "emb" so the reference's meta_parms filters work unchanged.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from mamdr_tpu_torch.models.layers import emb_init
from mamdr_tpu_torch.ops.embedding_lookup import embedding_lookup


def _table(pretrained: Optional[np.ndarray], shape, generator) -> nn.Parameter:
    if pretrained is not None:
        if tuple(pretrained.shape) != tuple(shape):
            raise ValueError(f"pretrained shape {pretrained.shape} != {shape}")
        # shares the caller's buffer: parameters are never written in place
        return nn.Parameter(torch.from_numpy(np.asarray(pretrained, np.float32)))
    return nn.Parameter(emb_init(torch.empty(shape), generator))


class EmbeddingBlock(nn.Module):
    """Field embeddings -> (u, p, d), each [B, dim]."""

    def __init__(self, n_uid: int, n_pid: int, n_domain: int,
                 user_dim: int, item_dim: int, domain_dim: int,
                 pretrained_user: Optional[np.ndarray] = None,
                 pretrained_item: Optional[np.ndarray] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.user_emb = _table(pretrained_user, (n_uid, user_dim), generator)
        self.item_emb = _table(pretrained_item, (n_pid, item_dim), generator)
        self.domain_emb = _table(None, (n_domain, domain_dim), generator)

    def forward(self, uid, pid, domain):
        return (
            embedding_lookup(self.user_emb, uid),
            embedding_lookup(self.item_emb, pid),
            embedding_lookup(self.domain_emb, domain),
        )
