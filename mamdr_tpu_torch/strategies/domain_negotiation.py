"""Domain Negotiation (DN): a sequential cross-domain pass, then a Reptile
outer update.

Counterpart of ``mamdr_tpu/strategies/domain_negotiation.py`` (:21-59).
Reference model_zoo/domain_negotiation.py:14-147. Per epoch: shuffle the
domain sequence (or keep a fixed ``meta_sequence`` list's order when
``shuffle_sequence`` is off), load the meta weights once, train through every
domain without reset (optimizer slots carried throughout; each domain's
epoch at most ``meta_train_step`` steps), then meta += (θ_final - meta) *
meta_lr (``fused.make_fused_dn``: K1 and K2 on every step on the card),
followed by the validation, early stop and best snapshot of every meta epoch
(``MetaStrategy.epoch_tail``). A target domain, and a train block past the
fused pass's memory budget, take the JAX package's per-call loop, which is
not ported and is refused.
"""

from __future__ import annotations

import numpy as np

from mamdr_tpu_torch.strategies.meta_base import MetaStrategy
from mamdr_tpu_torch.train import fused


class DomainNegotiationStrategy(MetaStrategy):
    def train(self) -> None:
        t = self.trainer
        if self.target_domain >= 0 or not t.fused_padding_ok(ragged=True):
            raise NotImplementedError(
                "DN with a target domain, or with a train block past the fused pass's "
                "memory budget, takes the JAX package's per-call loop, which is not ported "
                "yet (ROADMAP.md, open items §1: _train_loop)")
        self._train_fused()

    def _train_fused(self) -> None:
        t = self.trainer
        block, n_steps = t.train_block()
        dn_epoch = fused.make_fused_dn(
            t.train_step_fn(), self.mask, n_steps, t.dataset.batch_size,
            cap_steps=self.tc.meta_train_step, steps_list=t.steps_per_domain())
        self.meta = t.state.params
        sequence = self.meta_sequence()
        for epoch in range(self.tc.epoch):
            if t.verbose:
                print(f"Epoch: {epoch}", "-" * 30)
            if self.tc.shuffle_sequence:
                t.np_rng.shuffle(sequence)
            t.state, self.meta, _ = dn_epoch(
                t.state, self.meta, block, np.asarray(sequence, np.int32), t.gen,
                float(self.tc.meta_learning_rate))
            if self.epoch_tail(epoch):
                break
