"""Shared machinery for the meta strategies: the meta-parameter mask and the
domain sequence (counterpart of ``mamdr_tpu/strategies/meta_base.py:24-74``
and ``strategies/base.py``)."""

from __future__ import annotations

from typing import List

from mamdr_tpu_torch.train.trainer import Trainer
from mamdr_tpu_torch.utils import trees


class MetaStrategy:
    def __init__(self, trainer: Trainer):
        self.trainer = trainer
        self.tc = trainer.config.train
        self.n_domain = trainer.dataset.n_domain
        self.mask = trees.meta_parm_mask(trainer.state.params, self.tc.meta_parms)
        # Meta params are drawn from TRAINABLE weights only (reference
        # maml.py:159 iterates model.trainable_weights): frozen user/item
        # tables are never meta parameters even under meta_parms=["all"].
        if not self.tc.emb_trainable:
            self.mask = trees.named_tree_map(
                lambda n, m: bool(m) and not ("user_emb" in n or "item_emb" in n),
                self.mask,
            )
        self.target_domain: int = self.tc.target_domain

    def domain_sequence(self) -> List[int]:
        """All domains minus the target (reference maml.py:67-68)."""
        return [
            i for i in range(self.n_domain)
            if not (self.target_domain >= 0 and i == self.target_domain)
        ]

    def meta_sequence(self) -> List[int]:
        """DN/MAMDR sequence: explicit list config or domain order
        (reference domain_negotiation.py:125-146)."""
        seq = self.domain_sequence()
        ms = self.tc.meta_sequence
        if isinstance(ms, list):
            if len(ms) != len(seq):
                raise ValueError("All the domains must be given in the sequence")
            return list(ms)
        return seq
