"""Joint training: sequential shuffled per-domain epochs with early stopping.

Counterpart of ``mamdr_tpu/strategies/joint.py`` (:21-84). Reference loop:
model_zoo/DeepCTR/deepctr.py:63-93. Per epoch: shuffle the domain order
(numpy, ``Trainer.np_rng``), one epoch per domain in that order chained
without reset (``fused.make_fused_passes``: K1 and K2 on every step on the
card), the ``train_epoch`` metrics event, validation of every domain, the
early stop on the macro val AUC with the best weights kept, and, when
verbose, the best weights' test report. Where the fused pass does not
apply (``Trainer.fused_padding_ok``: a fixed train order, or a block past
its memory budget) the epoch is the per-domain loop of ``Trainer.fit_domain``
calls (JAX joint.py:59-63), which logs no train event, as there. Both
routes resume from the snapshot with the best weights (``train.resume``)
and write it every ``resume_every`` epochs (JAX joint.py:38-41, :71-79).
"""

from __future__ import annotations

import numpy as np

from mamdr_tpu_torch.strategies.base import Strategy
from mamdr_tpu_torch.train import fused
from mamdr_tpu_torch.utils import trace


class JointStrategy(Strategy):
    def train(self) -> None:
        t = self.trainer
        use_fused = t.fused_padding_ok(ragged=True)
        if use_fused:
            block, n_steps = t.train_block()
            sequential_pass = fused.make_fused_passes(
                t.train_step_fn(), n_steps, t.dataset.batch_size,
                steps_list=t.steps_per_domain())
        sequence = list(range(self.n_domain))
        start_epoch = 0
        resumed = t.try_resume({"best_params": t.state.params})
        if resumed is not None:
            start_epoch = resumed[0]
            t.best_params = resumed[1].get("best_params", t.state.params)
        for epoch in t.epochs(start_epoch):
            if t.verbose:
                print(f"Epoch: {epoch}", "-" * 30)
            t.np_rng.shuffle(sequence)
            if use_fused:
                t.state, losses = sequential_pass(t.state, block,
                                                  np.asarray(sequence, np.int32), t.gen)
                t.metrics.log("train_epoch", epoch=epoch, domain_loss={
                    str(sequence[i]): float(v) for i, v in enumerate(trace.to_host(losses))})
            else:
                for idx in sequence:
                    if t.verbose:
                        print(f"Train on: Domain {idx}")
                    t.state, _ = t.fit_domain(t.state, idx)
            if t.verbose:
                print("Val Result: ")
            with trace.span("trainer.validate"):
                _, avg_auc, _, _ = t.val_and_test("val")
            if t.stopper.step(avg_auc):
                break
            if t.stopper.improved:
                t.save_checkpoint()
            if t.resume_due(epoch):
                t.save_resume_state(epoch, extra_trees={
                    "best_params": t.best_params if t.best_params is not None
                    else t.state.params})
            if t.verbose:
                # the best weights' test report (reference base_model.py:121)
                print("Test Result: ")
                self.test()
