"""Shared machinery for the meta strategies: the meta-parameter mask, the
domain sequence, the support/query split, the target domain's epoch, the
meta-finetune validation, the validation / early-stop tail of every meta
epoch, and the resume snapshot of the fused loops (counterpart of
``mamdr_tpu/strategies/meta_base.py:24-260``).

``try_resume_meta`` / ``maybe_snapshot`` (JAX meta_base.py:232-251) resume
and snapshot the fused loops of DN, Reptile and MAML / MLDG; no per-call
loop resumes, as in the JAX package.

The meta-finetune validation (``meta_finetune_step > 0``, reference
maml.py:245-287) trains every domain ``meta_finetune_step`` epochs from the
trainer's current state — params, batch statistics, the model's live Adam
slots and step — and scores its val split; ``t.state`` is left as it was.
All domains run as lanes through the lane step (K1-lanes for the plain MLP,
the autograd lane step otherwise) when the ragged gate allows, else one
after another through ``Trainer.fit_domain`` / ``evaluate_domain``."""

from __future__ import annotations

from typing import Dict, List, Tuple

from mamdr_tpu_torch.data.dataset import split_support_query
from mamdr_tpu_torch.strategies.base import Strategy
from mamdr_tpu_torch.train import fused
from mamdr_tpu_torch.train.steps import make_subset_train_step
from mamdr_tpu_torch.train.trainer import Trainer
from mamdr_tpu_torch.utils import trace, trees


class MetaStrategy(Strategy):
    def __init__(self, trainer: Trainer):
        super().__init__(trainer)
        # Meta params are drawn from TRAINABLE weights only (reference
        # maml.py:159 iterates model.trainable_weights): frozen user/item
        # tables are never meta parameters even under meta_parms=["all"].
        self.mask = trees.tree_map(
            lambda m, f: bool(m) and not f,
            trees.meta_parm_mask(trainer.state.params, self.tc.meta_parms),
            trainer.frozen_mask())
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

    def meta_finetune_val(self) -> Tuple[float, float, Dict, Dict]:
        """Every domain finetuned ``meta_finetune_step`` epochs from
        ``t.state``, then its val split (JAX ``meta_finetune_val``,
        meta_base.py:100-124): as lanes when the ragged gate allows
        (``_meta_finetune_val_fused``), else domain by domain."""
        t = self.trainer
        if t.fused_padding_ok(ragged=True):
            return self._meta_finetune_val_fused()
        domain_loss, domain_auc = {}, {}
        for idx in range(self.n_domain):
            state = t.state
            for _ in range(self.tc.meta_finetune_step):
                state, _ = t.fit_domain(state, idx)
            loss, auc = t.evaluate_domain("val", idx, state.params, state.batch_stats)
            domain_loss[str(idx)], domain_auc[str(idx)] = loss, auc
        return self._finish_meta_finetune_val(domain_loss, domain_auc)

    def _finish_meta_finetune_val(self, domain_loss, domain_auc):
        """(macro loss, macro AUC, dicts), printed when verbose; like the
        JAX package's, it logs no metrics event."""
        avg_loss = sum(domain_loss.values()) / len(domain_loss)
        avg_auc = sum(domain_auc.values()) / len(domain_auc)
        if self.trainer.verbose:
            print("Loss: ", domain_loss)
            print("AUC: ", domain_auc)
            print(f"Overall val Loss: {avg_loss}, AUC: {avg_auc}")
        return avg_loss, avg_auc, domain_loss, domain_auc

    def _meta_finetune_val_fused(self) -> Tuple[float, float, Dict, Dict]:
        """Every domain a lane (JAX ``_meta_finetune_val_fused``,
        meta_base.py:136-198): each lane starts from ``t.state``'s params
        (frozen tables shared, ``make_subset_train_step``), batch statistics,
        Adam slots and step, with its own dropout seed; ``meta_finetune_step``
        shuffled epochs of the train block through the lane step with the
        model's optimizer (a shorter domain's extra lane-steps are all-pad
        no-ops), then one lane eval of the val block."""
        t = self.trainer
        d = self.n_domain
        train_step, to_sub, combine = make_subset_train_step(
            t.model, t.tx, t.step_cfg, t.frozen_mask(), t.state.params)
        block, n_steps = t.train_block()
        epoch_all, eval_all, _ = fused.make_fused_separate(
            train_step, t.model, t.step_cfg, n_steps, t.dataset.batch_size, combine)
        copies = trees.tree_map(lambda x: False, t.state.params)  # every leaf its own lanes
        states = fused.make_lane_state(t.state, to_sub(t.state.params), copies, d)
        states = states.replace(batch_stats=trees.tree_map(
            lambda x: x.expand(d, *x.shape), t.state.batch_stats))
        for _ in range(self.tc.meta_finetune_step):
            states, _ = epoch_all(states, block, t.gen)
        losses, aucs = eval_all(states.params, t.eval_block("val"), stats=states.batch_stats)
        return self._finish_meta_finetune_val(*t.domain_dicts(losses, aucs))

    def validate(self) -> Tuple[float, float, Dict, Dict]:
        """The meta-finetune validation when ``meta_finetune_step > 0``, else
        every domain's val split with ``val_params_fn``'s weights."""
        if self.trainer.verbose:
            print("Val Result: ")
        if self.tc.meta_finetune_step > 0:
            return self.meta_finetune_val()
        return self.trainer.val_and_test("val", params_fn=self.val_params_fn)

    def epoch_tail(self, epoch: int) -> bool:
        """Validation, early stop and best snapshot after a meta epoch
        (reference maml.py:124-150); when verbose, the best weights' test
        report. Returns True to stop training."""
        t = self.trainer
        if epoch % self.tc.val_every_step != 0:
            return False
        with trace.span("trainer.validate"):
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

    # ---------------- the resume snapshot (fused loops) ----------------

    # {extra tree name: the flat Adam whose state it is} (MAML's meta-Adam)
    snapshot_optimizers: Dict = {}

    def try_resume_meta(self, extra: Dict) -> Tuple[int, Dict]:
        """(start epoch, extra trees): with ``train.resume`` and a snapshot,
        the trainer's state, early stop and random streams restored and the
        saved trees of ``extra``'s names (meta weights, meta-optimizer
        slots) in place of its values; else (0, ``extra``)."""
        resumed = self.trainer.try_resume(extra, self.snapshot_optimizers)
        if resumed is None:
            return 0, extra
        start, ex = resumed
        return start, {k: ex.get(k, v) for k, v in extra.items()}

    def maybe_snapshot(self, epoch: int, extra: Dict) -> None:
        """The resume snapshot after every ``resume_every``-th epoch."""
        if self.trainer.resume_due(epoch):
            self.trainer.save_resume_state(epoch, extra_trees=extra,
                                           optimizers=self.snapshot_optimizers)

    def fit_target_domain(self, state):
        """A whole epoch on the target domain after the outer update, when
        there is one (reference maml.py:125-128, domain_negotiation.py:90-94;
        JAX meta_base.py:253-260)."""
        if self.target_domain >= 0:
            if self.trainer.verbose:
                print(f"Train on target domain: {self.target_domain}")
            state, _ = self.trainer.fit_domain(state, self.target_domain)
        return state
