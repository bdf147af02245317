"""Shared machinery for the meta strategies: the meta-parameter mask, the
domain sequence, the support/query split, and the validation / early-stop
tail of every meta epoch (counterpart of
``mamdr_tpu/strategies/meta_base.py:24-94, 96-230``). The
meta-finetune validation (``meta_finetune_step > 0``) is not ported and is
refused."""

from __future__ import annotations

from typing import Dict, List, Tuple

from mamdr_tpu_torch.data.dataset import split_support_query
from mamdr_tpu_torch.strategies.base import Strategy
from mamdr_tpu_torch.train.trainer import Trainer
from mamdr_tpu_torch.utils import trees


class MetaStrategy(Strategy):
    def __init__(self, trainer: Trainer):
        super().__init__(trainer)
        if self.tc.meta_finetune_step > 0:
            raise NotImplementedError(
                f"meta_finetune_step={self.tc.meta_finetune_step}: the meta-finetune "
                "validation is not ported yet (ROADMAP.md, open items §1: meta_finetune_val)")
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

    def support_query(self, idx: int):
        """Domain idx's support/query split, drawn from ``np_rng``; a target
        domain redirects the query set to the target's train split
        (reference maml.py:335-337)."""
        t = self.trainer
        support, query = split_support_query(
            t.dataset.train[idx], self.tc.meta_split, self.tc.meta_split_ratio, t.np_rng)
        if self.target_domain >= 0:
            query = t.dataset.train[self.target_domain]
        return support, query

    def cap_steps(self, n_batches: int) -> int:
        """At most ``meta_train_step`` of `n_batches` when that is positive."""
        if self.tc.meta_train_step > 0:
            return min(n_batches, self.tc.meta_train_step)
        return n_batches

    # ---------------- validation / early stop ----------------

    def val_params_fn(self, idx: int):
        return self.trainer.state.params

    def validate(self) -> Tuple[float, float, Dict, Dict]:
        if self.trainer.verbose:
            print("Val Result: ")
        return self.trainer.val_and_test("val", params_fn=self.val_params_fn)

    def epoch_tail(self, epoch: int) -> bool:
        """Validation, early stop and best snapshot after a meta epoch
        (reference maml.py:124-150); when verbose, the best weights' test
        report. Returns True to stop training."""
        t = self.trainer
        if epoch % self.tc.val_every_step != 0:
            return False
        _, avg_auc, _, domain_auc = self.validate()
        metric = domain_auc[str(self.target_domain)] if self.target_domain >= 0 else avg_auc
        if t.stopper.step(metric):
            return True
        if t.stopper.improved:
            self.save_best()
        if t.verbose:
            print("Test Result: ")
            self.test()
        return False

    def save_best(self) -> None:
        self.trainer.save_checkpoint()
