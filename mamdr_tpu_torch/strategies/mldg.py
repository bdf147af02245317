"""MLDG: Meta-Learning Domain Generalization.

Counterpart of ``mamdr_tpu/strategies/mldg.py``. Reference
model_zoo/mldg.py:16-366: MAML's scaffolding with another inner loop
(mldg.py:92-119). Per domain:

  1. load meta θ; accumulate the SUPPORT gradients at θ (no inner Adam);
  2. a mid-stream meta-Adam step gives the adapted θ' — it advances the
     meta-Adam's moments and count and does NOT clear the accumulator;
  3. accumulate the QUERY gradients at θ' into the same accumulator
     (acc = g_support(θ) + g_query(θ'));
  4. apply the accumulator with the meta-Adam at meta (per-domain mode:
     now, and clear; ``*_batch``: at the epoch's end).

Net effect: θ <- AdamUpdate(θ, ∇F(θ) + ∇G(θ - α∇F)), the reference's two
meta-Adam moment updates per domain included. Everything else — splits,
routing, the epoch tail — is MAML's (``fused.make_fused_maml`` with
``mldg``); the per-call loop (``_train_loop``, JAX :28-67) takes both
gradient passes through ``accumulate_split``.
"""

from __future__ import annotations

from mamdr_tpu_torch.strategies import ops
from mamdr_tpu_torch.strategies.maml import MAMLStrategy
from mamdr_tpu_torch.train import fused


class MLDGStrategy(MAMLStrategy):
    _mldg = True

    def _train_loop(self) -> None:
        t = self.trainer
        sequence = self.domain_sequence()
        batch_mode = self.spec.batch_update
        splits = {idx: self.support_query(idx) for idx in sequence}  # drawn once
        acc = fused.zeros_acc(self.mask, self.meta)
        for epoch in t.epochs():
            if t.verbose:
                print(f"Epoch: {epoch}", "-" * 30)
            t.np_rng.shuffle(sequence)
            for idx in sequence:
                support, query = splits[idx]
                # the support gradients at meta θ
                t.state = t.state.replace(params=ops.load_masked(t.state.params, self.meta,
                                                                 self.mask))
                acc = self.accumulate_split(t.state.params, support, acc,
                                            stats=t.state.batch_stats)
                # mid-stream apply -> θ': the meta-Adam moves, acc is kept
                adapted, self.meta_opt_state = fused.meta_step(
                    self.meta_tx, t.state.params, self.meta_opt_state, acc, self.mask,
                    self.grad_scale())
                t.state = t.state.replace(params=adapted)
                # the query gradients at θ' into the same accumulator
                acc = self.accumulate_split(t.state.params, query, acc,
                                            stats=t.state.batch_stats)
                if not batch_mode:
                    self.meta = self.meta_apply(self.meta, acc)
                    acc = fused.zeros_acc(self.mask, self.meta)
            if batch_mode:
                self.meta = self.meta_apply(self.meta, acc)
                acc = fused.zeros_acc(self.mask, self.meta)
            t.state = t.state.replace(params=ops.load_masked(t.state.params, self.meta,
                                                             self.mask))
            t.state = self.fit_target_domain(t.state)
            if self.epoch_tail(epoch):
                break
