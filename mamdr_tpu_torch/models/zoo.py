"""Model factory: config -> torch module (substring dispatch like run.py:37-47).

Only the MLP tower is ported so far; other base models raise.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mamdr_tpu_torch.config import ExperimentConfig
from mamdr_tpu_torch.models.deepctr import MLP


def build_model(
    config: ExperimentConfig,
    n_uid: int,
    n_pid: int,
    n_domain: int,
    pretrained_user: Optional[np.ndarray] = None,
    pretrained_item: Optional[np.ndarray] = None,
    generator: Optional[torch.Generator] = None,
):
    """Instantiate the base model for a config. Pretrained tables are used
    only when ``train.load_pretrain_emb`` is set (reference deepctr.py:104-116)."""
    mc = config.model
    spec = mc.spec
    if spec.base != "mlp":
        raise NotImplementedError(f"base model {spec.base!r} is not ported yet")
    if mc.compute_dtype != "float32":
        raise NotImplementedError("the port computes the tower in float32 only")
    if not config.train.load_pretrain_emb:
        pretrained_user = pretrained_item = None
    return MLP(
        n_uid=n_uid, n_pid=n_pid, n_domain=n_domain,
        user_dim=mc.user_dim, item_dim=mc.item_dim, domain_dim=mc.domain_dim,
        hidden_dim=tuple(mc.hidden_dim), dropout=mc.dropout,
        pretrained_user=pretrained_user, pretrained_item=pretrained_item,
        generator=generator,
    )
