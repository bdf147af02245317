"""First-order MAML over domains.

Counterpart of ``mamdr_tpu/strategies/maml.py`` (:26-145). Reference
model_zoo/maml.py:16-363. Support and query splits are drawn once before
training (``meta_split``: "train-train" uses the whole train set for both;
"meta-train/val" an exclusive split of each domain, ``meta_split_ratio``
of it the support), as the reference's build-once split does. Per epoch,
per (shuffled) domain: load the meta weights, adapt with the model's OWN
Adam on the support split (its slots and step persist across domains),
accumulate the query split's gradients at the adapted weights with dropout
off (K1 at rate 0 on the card), then apply the accumulator with a separate
meta-Adam (``meta_learning_rate``) at the meta weights — or, for a
``*_batch`` model name, once at the epoch's end (``fused.make_fused_maml``).
No second-order term anywhere. Each epoch ends with
``MetaStrategy.epoch_tail`` and, on the fused route, the resume snapshot
with the meta weights and the meta-Adam's slots (``maybe_snapshot``, JAX
:128-145).

The meta-Adam is the flat Adam over the meta mask (the trainable subset):
on the masked leaves it is the JAX package's ``optax.chain(masked(
set_to_zero), adam)``, whose other leaves never move; here they carry no
slot and pass through by reference.

``average_meta_grad``: "none" sums; "mean" divides by
n_domain * meta_train_step at the apply, only when meta_train_step > 0
(maml.py:206-211); "moving_mean" accumulates acc*0.999 + g*0.001; "drop"
adds each gradient after inverted dropout (p 0.2) of its 1-D leaves
(``fused.accumulate_grads``: hash masks seeded from ``Trainer.draw_seed``). "drop", a target domain, a fixed train order
and a train block past the fused pass's memory budget take the per-call
loop (``_train_loop``, JAX :147-186): the same epoch over
``Trainer.fit_domain`` (the support epoch) and ``accumulate_split`` (the
query gradients, a fresh order from ``np_rng`` each call), with a target
domain's train split as every query and a whole epoch on it after each
outer update (``fit_target_domain``).
"""

from __future__ import annotations

import numpy as np

from mamdr_tpu_torch.data.dataset import split_support_query
from mamdr_tpu_torch.strategies import ops
from mamdr_tpu_torch.strategies.meta_base import MetaStrategy
from mamdr_tpu_torch.train import fused
from mamdr_tpu_torch.train.flat_optimizer import FlatAdam
from mamdr_tpu_torch.utils import trace


class MAMLStrategy(MetaStrategy):
    _mldg = False  # MLDGStrategy: the fused epoch takes MLDG's inner-loop shape

    def __init__(self, trainer):
        super().__init__(trainer)
        self.meta_tx = FlatAdam(self.tc.meta_learning_rate, self.mask)
        self.meta_opt_state = self.meta_tx.init(trainer.state.params)
        self.meta = trainer.state.params
        self.snapshot_optimizers = {"meta_opt": self.meta_tx}

    def grad_scale(self) -> float:
        """'mean' divides by n_domain*meta_train_step iff meta_train_step>0."""
        if self.tc.average_meta_grad == "mean" and self.tc.meta_train_step > 0:
            return 1.0 / (self.n_domain * self.tc.meta_train_step)
        return 1.0

    def accumulate_split(self, params, split, acc, cap: bool = True, stats=None):
        """Add the gradients over one split at fixed params to ``acc`` (JAX
        ``accumulate_split``): the split's batches in an order drawn from
        ``np_rng`` (``Trainer.stack_split``, shuffled whatever
        ``fixed_train`` says, as the JAX package's is), at most
        ``meta_train_step`` of them when ``cap``, through ``fused.grad_epoch``
        in the ``average_meta_grad`` mode; the norms read ``stats`` (a model's
        batch statistics)."""
        t = self.trainer
        stacked = t.stack_split(split, shuffle=True,
                                max_steps=self.tc.meta_train_step if cap else 0)
        return fused.grad_epoch(t.accum_grad_fn, params, stacked, acc, self.mask,
                                self._accumulate(), stats, drop_seeds=t.draw_seed)

    def meta_apply(self, meta, grads):
        """meta + one meta-Adam step on grads * grad_scale() (masked leaves)."""
        new_meta, self.meta_opt_state = fused.meta_step(
            self.meta_tx, meta, self.meta_opt_state, grads, self.mask, self.grad_scale())
        return new_meta

    def _accumulate(self) -> str:
        """The accumulate mode of ``average_meta_grad`` (JAX trainer.py:129)."""
        return {"moving_mean": "ema", "drop": "drop"}.get(self.tc.average_meta_grad, "sum")

    def train(self) -> None:
        if (self.target_domain < 0 and self.tc.average_meta_grad != "drop"
                and self.trainer.fused_padding_ok(ragged=True)):
            self._train_fused()
        else:
            self._train_loop()

    def _train_fused(self) -> None:
        t = self.trainer
        b = t.dataset.batch_size
        supports, queries = [], []
        for idx in range(self.n_domain):
            s, q = split_support_query(t.dataset.train[idx], self.tc.meta_split,
                                       self.tc.meta_split_ratio, t.np_rng)
            supports.append(s)
            queries.append(q)
        sup_block, n_steps_s = fused.stack_domains_on_device(supports, b, t.device)
        sup_steps = fused.domain_step_counts(supports, b)
        if self.tc.meta_split == "train-train":
            q_block, n_steps_q, q_steps = sup_block, n_steps_s, sup_steps
        else:
            q_block, n_steps_q = fused.stack_domains_on_device(queries, b, t.device)
            q_steps = fused.domain_step_counts(queries, b)
        maml_epoch = fused.make_fused_maml(
            t.train_step_fn(), t.accum_grad_fn, self.mask, self.meta_tx, n_steps_s,
            n_steps_q, b, batch_mode=self.spec.batch_update,
            cap_steps=self.tc.meta_train_step, accumulate=self._accumulate(),
            mldg=self._mldg, steps_list_support=sup_steps, steps_list_query=q_steps)
        sequence = self.domain_sequence()
        start_epoch, ex = self.try_resume_meta(
            {"meta": self.meta, "meta_opt": self.meta_opt_state})
        self.meta, self.meta_opt_state = ex["meta"], ex["meta_opt"]
        for epoch in t.epochs(start_epoch):
            if t.verbose:
                print(f"Epoch: {epoch}", "-" * 30)
            t.np_rng.shuffle(sequence)
            t.state, self.meta, self.meta_opt_state = maml_epoch(
                t.state, self.meta, self.meta_opt_state, sup_block, q_block,
                np.asarray(sequence, np.int32), t.gen, self.grad_scale())
            if self.epoch_tail(epoch):
                break
            self.maybe_snapshot(epoch, {"meta": self.meta, "meta_opt": self.meta_opt_state})

    def _train_loop(self) -> None:
        t = self.trainer
        sequence = self.domain_sequence()
        batch_mode = self.spec.batch_update
        # splits drawn once before training (reference build_meta_data_split,
        # maml.py:294-341), in domain order
        splits = {idx: self.support_query(idx) for idx in sequence}
        acc = fused.zeros_acc(self.mask, self.meta)
        for epoch in t.epochs():
            if t.verbose:
                print(f"Epoch: {epoch}", "-" * 30)
            t.np_rng.shuffle(sequence)
            for idx in sequence:
                support, query = splits[idx]
                t.state = t.state.replace(params=ops.load_masked(t.state.params, self.meta,
                                                                 self.mask))
                # inner adaptation from meta with the model's own optimizer
                t.state, loss = t.fit_domain(t.state, idx, split=support,
                                             max_steps=self.tc.meta_train_step)
                if t.verbose:
                    print(f"Train on: Domain {idx}, Loss: {float(trace.to_host(loss)):.4f}")
                # the query's gradients at the adapted weights
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
