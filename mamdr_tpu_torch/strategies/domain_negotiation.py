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
(``MetaStrategy.epoch_tail``) and the resume snapshot with the meta weights
(``maybe_snapshot``; ``train.resume`` continues from it, JAX :45, :59). A
target domain, a fixed train order or a train block past the fused pass's
memory budget take the per-call loop (``_train_loop``, JAX :61-93), which
neither writes nor reads the snapshot: the target domain is appended to the
sequence, its epoch uncapped, and after the outer update one more epoch on
it (``fit_target_domain``).
"""

from __future__ import annotations

import numpy as np

from mamdr_tpu_torch.strategies import ops
from mamdr_tpu_torch.strategies.meta_base import MetaStrategy
from mamdr_tpu_torch.train import fused
from mamdr_tpu_torch.utils import trace


class DomainNegotiationStrategy(MetaStrategy):
    def train(self) -> None:
        if self.target_domain < 0 and self.trainer.fused_padding_ok(ragged=True):
            self._train_fused()
        else:
            self._train_loop()

    def _train_fused(self) -> None:
        t = self.trainer
        block, n_steps = t.train_block()
        dn_epoch = fused.make_fused_dn(
            t.train_step_fn(), self.mask, n_steps, t.dataset.batch_size,
            cap_steps=self.tc.meta_train_step, steps_list=t.steps_per_domain())
        sequence = self.meta_sequence()
        start_epoch, ex = self.try_resume_meta({"meta": t.state.params})
        self.meta = ex["meta"]
        for epoch in t.epochs(start_epoch):
            if t.verbose:
                print(f"Epoch: {epoch}", "-" * 30)
            if self.tc.shuffle_sequence:
                t.np_rng.shuffle(sequence)
            t.state, self.meta, _ = dn_epoch(
                t.state, self.meta, block, np.asarray(sequence, np.int32), t.gen,
                float(self.tc.meta_learning_rate))
            if self.epoch_tail(epoch):
                break
            self.maybe_snapshot(epoch, {"meta": self.meta})

    def _train_loop(self) -> None:
        t = self.trainer
        self.meta = t.state.params
        sequence = self.meta_sequence()
        for epoch in t.epochs():
            if t.verbose:
                print(f"Epoch: {epoch}", "-" * 30)
            if self.tc.shuffle_sequence:
                t.np_rng.shuffle(sequence)
            train_sequence = list(sequence)
            if self.target_domain >= 0:
                train_sequence.append(self.target_domain)
            # meta loaded once an epoch; the domains chain without reset
            t.state = t.state.replace(params=ops.load_masked(t.state.params, self.meta,
                                                             self.mask))
            for idx in train_sequence:
                cap = self.tc.meta_train_step if idx != self.target_domain else 0
                t.state, loss = t.fit_domain(t.state, idx, max_steps=cap)
                if t.verbose:
                    print(f"Train on: Domain {idx}, Loss: {float(trace.to_host(loss)):.4f}")
            self.meta = ops.reptile_update(self.meta, t.state.params,
                                           float(self.tc.meta_learning_rate), self.mask)
            t.state = t.state.replace(params=ops.load_masked(t.state.params, self.meta,
                                                             self.mask))
            t.state = self.fit_target_domain(t.state)
            if self.epoch_tail(epoch):
                break
