"""Model factory: config -> torch module (substring dispatch like run.py:37-47).

Counterpart of ``mamdr_tpu/models/zoo.py``: the single-tower models of
``models/deepctr.py``, the MTL models of ``models/mtl.py`` and STAR
(``models/star.py``). ``compute_dtype`` goes to the single-tower models,
whose DNN and logit head compute in it; the MTL models and STAR accept it
and compute in float32, as the JAX package's do.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mamdr_tpu_torch.config import ExperimentConfig
from mamdr_tpu_torch.models import deepctr
from mamdr_tpu_torch.models.mtl import MMoE, PLE, SharedBottom
from mamdr_tpu_torch.models.star import Star

_DEEPCTR = {
    "mlp": deepctr.MLP,
    "wdl": deepctr.WDL,
    "nfm": deepctr.NFM,
    "autoint": deepctr.AutoInt,
    "ccpm": deepctr.CCPM,
    "pnn": deepctr.PNN,
    "deepfm": deepctr.DeepFM,
}
_MTL = {"shared_bottom": SharedBottom, "mmoe": MMoE, "ple": PLE}


def build_model(
    config: ExperimentConfig,
    n_uid: int,
    n_pid: int,
    n_domain: int,
    pretrained_user: Optional[np.ndarray] = None,
    pretrained_item: Optional[np.ndarray] = None,
    generator: Optional[torch.Generator] = None,
    expert_mesh=None,
):
    """Instantiate the base model for a config, its init drawn from
    ``generator``. Pretrained tables are used only when
    ``train.load_pretrain_emb`` is set (reference deepctr.py:104-116). An
    MMoE or PLE built with ``expert_mesh`` runs a rank's slice of its expert
    banks on that mesh (``train.shard_experts``, models/mtl.py)."""
    mc = config.model
    spec = mc.spec
    if not config.train.load_pretrain_emb:
        pretrained_user = pretrained_item = None
    common = dict(
        n_uid=n_uid, n_pid=n_pid, n_domain=n_domain,
        user_dim=mc.user_dim, item_dim=mc.item_dim, domain_dim=mc.domain_dim,
        hidden_dim=tuple(mc.hidden_dim), dropout=mc.dropout,
        pretrained_user=pretrained_user, pretrained_item=pretrained_item,
        generator=generator,
    )
    if spec.base_family == "star":
        common.pop("dropout")  # STAR has no dropout (the JAX model keeps the field unused)
        return Star(auxiliary_dim=mc.auxiliary_dim, norm=mc.norm, dense=mc.dense,
                    auxiliary_net=mc.auxiliary_net, **common)
    if spec.base_family == "deepctr":
        extra = {}
        if spec.base == "autoint":
            extra = dict(att_head_num=mc.att_head_num, att_layer_num=mc.att_layer_num)
        elif spec.base == "ccpm":
            extra = dict(conv_kernel_width=tuple(mc.conv_kernel_width),
                         conv_filters=tuple(mc.conv_filters))
        elif spec.base == "pnn":
            extra = dict(use_inner=mc.use_inner, use_outter=mc.use_outter)
        return _DEEPCTR[spec.base](**common, **extra, compute_dtype=mc.compute_dtype)
    if spec.base_family == "mtl":
        return _MTL[spec.base](
            tower_hidden_dim=tuple(mc.tower_hidden_dim),
            num_experts=mc.num_experts,
            gate_dnn_hidden_units=tuple(mc.gate_dnn_hidden_units),
            specific_expert_num=mc.specific_expert_num,
            shared_expert_num=mc.shared_expert_num,
            num_levels=mc.num_levels,
            expert_mesh=expert_mesh,
            **common,
        )
    raise ValueError(f"unknown base family {spec.base_family}")
