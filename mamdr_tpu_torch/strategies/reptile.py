"""Reptile: per-domain inner adaptation and a first-order meta interpolation.

Counterpart of ``mamdr_tpu/strategies/reptile.py`` (:18-56). Reference
model_zoo/reptile.py:14-155. Per epoch, per (shuffled) domain: load the meta
weights, an inner epoch of at most ``meta_train_step`` steps with the
model's own Adam (its slots and step count persist across domains: the
reference's SetVarOp assigns weights only), then meta += (adapted - meta) *
meta_lr; the "batch" variant (``*_batch`` model names) accumulates the
deltas over the domains and applies them once at the epoch's end, scaled by
meta_lr (``fused.make_fused_reptile``: K1 and K2 on every step on the card).
Each epoch ends with ``MetaStrategy.epoch_tail``. A target domain, and a
train block past the fused pass's memory budget, take the JAX package's
per-call loop, which is not ported and is refused.
"""

from __future__ import annotations

import numpy as np

from mamdr_tpu_torch.strategies.meta_base import MetaStrategy
from mamdr_tpu_torch.train import fused


class ReptileStrategy(MetaStrategy):
    def train(self) -> None:
        t = self.trainer
        if self.target_domain >= 0 or not t.fused_padding_ok(ragged=True):
            raise NotImplementedError(
                "Reptile with a target domain, or with a train block past the fused pass's "
                "memory budget, takes the JAX package's per-call loop, which is not ported "
                "yet (ROADMAP.md, open items §1: _train_loop)")
        self._train_fused()

    def _train_fused(self) -> None:
        t = self.trainer
        block, n_steps = t.train_block()
        reptile_epoch = fused.make_fused_reptile(
            t.train_step_fn(), self.mask, n_steps, t.dataset.batch_size,
            batch_mode=self.spec.batch_update, cap_steps=self.tc.meta_train_step,
            steps_list=t.steps_per_domain())
        self.meta = t.state.params
        sequence = self.domain_sequence()
        for epoch in range(self.tc.epoch):
            if t.verbose:
                print(f"Epoch: {epoch}", "-" * 30)
            t.np_rng.shuffle(sequence)
            t.state, self.meta, _ = reptile_epoch(
                t.state, self.meta, block, np.asarray(sequence, np.int32), t.gen,
                float(self.tc.meta_learning_rate))
            if self.epoch_tail(epoch):
                break
