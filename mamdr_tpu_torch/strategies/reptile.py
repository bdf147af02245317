"""Reptile: per-domain inner adaptation and a first-order meta interpolation.

Counterpart of ``mamdr_tpu/strategies/reptile.py`` (:18-56). Reference
model_zoo/reptile.py:14-155. Per epoch, per (shuffled) domain: load the meta
weights, an inner epoch of at most ``meta_train_step`` steps with the
model's own Adam (its slots and step count persist across domains: the
reference's SetVarOp assigns weights only), then meta += (adapted - meta) *
meta_lr; the "batch" variant (``*_batch`` model names) accumulates the
deltas over the domains and applies them once at the epoch's end, scaled by
meta_lr (``fused.make_fused_reptile``: K1 and K2 on every step on the card).
Each epoch ends with ``MetaStrategy.epoch_tail`` and, on the fused route,
the resume snapshot (``maybe_snapshot``, JAX :40, :53). A target domain, a fixed
train order or a train block past the fused pass's memory budget take the
per-call loop (``_train_loop``, JAX :55-96): there a target domain gets a
one-step nudge after each domain's inner epoch (reference reptile.py:83-87)
and a whole epoch after the outer update (``fit_target_domain``).
"""

from __future__ import annotations

import numpy as np
import torch

from mamdr_tpu_torch.strategies import ops
from mamdr_tpu_torch.strategies.meta_base import MetaStrategy
from mamdr_tpu_torch.train import fused
from mamdr_tpu_torch.utils import trees


class ReptileStrategy(MetaStrategy):
    def train(self) -> None:
        if self.target_domain < 0 and self.trainer.fused_padding_ok(ragged=True):
            self._train_fused()
        else:
            self._train_loop()

    def _train_fused(self) -> None:
        t = self.trainer
        block, n_steps = t.train_block()
        reptile_epoch = fused.make_fused_reptile(
            t.train_step_fn(), self.mask, n_steps, t.dataset.batch_size,
            batch_mode=self.spec.batch_update, cap_steps=self.tc.meta_train_step,
            steps_list=t.steps_per_domain())
        sequence = self.domain_sequence()
        start_epoch, ex = self.try_resume_meta({"meta": t.state.params})
        self.meta = ex["meta"]
        for epoch in t.epochs(start_epoch):
            if t.verbose:
                print(f"Epoch: {epoch}", "-" * 30)
            t.np_rng.shuffle(sequence)
            t.state, self.meta, _ = reptile_epoch(
                t.state, self.meta, block, np.asarray(sequence, np.int32), t.gen,
                float(self.tc.meta_learning_rate))
            if self.epoch_tail(epoch):
                break
            self.maybe_snapshot(epoch, {"meta": self.meta})

    def _train_loop(self) -> None:
        t = self.trainer
        m = self.mask
        meta_lr = float(self.tc.meta_learning_rate)
        self.meta = t.state.params
        sequence = self.domain_sequence()
        batch_mode = self.spec.batch_update
        for epoch in t.epochs():
            if t.verbose:
                print(f"Epoch: {epoch}", "-" * 30)
            t.np_rng.shuffle(sequence)
            acc = (trees.tree_map(lambda mm, x: torch.zeros_like(x) if mm else x, m, self.meta)
                   if batch_mode else None)
            for idx in sequence:
                t.state = t.state.replace(params=ops.load_masked(t.state.params, self.meta, m))
                # the domain's whole train split (reference reptile.py:144-155),
                # at most meta_train_step batches
                t.state, loss = t.fit_domain(t.state, idx, max_steps=self.tc.meta_train_step)
                if t.verbose:
                    print(f"Train on: Domain {idx}, Loss: {float(loss):.4f}")
                if self.target_domain >= 0:
                    # one step on the target inside the domain loop
                    t.state, _ = t.fit_domain(t.state, self.target_domain, max_steps=1)
                if batch_mode:
                    acc = ops.delta_accumulate(acc, t.state.params, self.meta, m)
                else:
                    self.meta = ops.reptile_update(self.meta, t.state.params, meta_lr, m)
            if batch_mode:
                self.meta = ops.scaled_add(self.meta, acc, meta_lr, m)
            t.state = t.state.replace(params=ops.load_masked(t.state.params, self.meta, m))
            t.state = self.fit_target_domain(t.state)
            if self.epoch_tail(epoch):
                break
