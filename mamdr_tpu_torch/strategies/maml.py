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
``MetaStrategy.epoch_tail``.

The meta-Adam is the flat Adam over the meta mask (the trainable subset):
on the masked leaves it is the JAX package's ``optax.chain(masked(
set_to_zero), adam)``, whose other leaves never move; here they carry no
slot and pass through by reference.

``average_meta_grad``: "none" sums; "mean" divides by
n_domain * meta_train_step at the apply, only when meta_train_step > 0
(maml.py:206-211); "moving_mean" accumulates acc*0.999 + g*0.001. "drop",
a target domain, and a train block past the fused pass's memory budget take
the JAX package's per-call loop, which is not ported and is refused.
"""

from __future__ import annotations

import numpy as np

from mamdr_tpu_torch.data.dataset import split_support_query
from mamdr_tpu_torch.strategies.meta_base import MetaStrategy
from mamdr_tpu_torch.train import fused
from mamdr_tpu_torch.train.flat_optimizer import flat_adam


class MAMLStrategy(MetaStrategy):
    _mldg = False  # MLDGStrategy: the fused epoch takes MLDG's inner-loop shape

    def __init__(self, trainer):
        super().__init__(trainer)
        self.meta_tx = flat_adam(self.tc.meta_learning_rate, self.mask)
        self.meta_opt_state = self.meta_tx.init(trainer.state.params)
        self.meta = trainer.state.params

    def grad_scale(self) -> float:
        """'mean' divides by n_domain*meta_train_step iff meta_train_step>0."""
        if self.tc.average_meta_grad == "mean" and self.tc.meta_train_step > 0:
            return 1.0 / (self.n_domain * self.tc.meta_train_step)
        return 1.0

    def accumulate_split(self, params, split, acc, cap: bool = True, stats=None):
        """Add the gradients over one split at fixed params to ``acc`` (JAX
        ``accumulate_split``): the split's rows in an order drawn from
        ``np_rng`` (as the JAX package's ``stack_batches`` draws it), at most
        ``meta_train_step`` batches when ``cap``; the norms read ``stats``
        (a model's batch statistics)."""
        t = self.trainer
        order = t.np_rng.permutation(split.n)
        block, n_steps = fused.stack_domains_on_device([split.take(order)],
                                                       t.dataset.batch_size, t.device)
        return fused._grad_epoch_on_flat(
            t.accum_grad_fn, params, {k: v[0] for k, v in block.items()}, t.gen, n_steps,
            t.dataset.batch_size, acc, self.mask, self._accumulate(),
            self.tc.meta_train_step if cap else 0, shuffle=False, stats=stats)

    def meta_apply(self, meta, grads):
        """meta + one meta-Adam step on grads * grad_scale() (masked leaves)."""
        new_meta, self.meta_opt_state = fused.meta_step(
            self.meta_tx, meta, self.meta_opt_state, grads, self.mask, self.grad_scale())
        return new_meta

    def _accumulate(self) -> str:
        return "ema" if self.tc.average_meta_grad == "moving_mean" else "sum"

    def train(self) -> None:
        t = self.trainer
        if (self.target_domain >= 0 or self.tc.average_meta_grad == "drop"
                or not t.fused_padding_ok(ragged=True)):
            raise NotImplementedError(
                f"{self.spec.raw!r} with a target domain, average_meta_grad 'drop', or a "
                "train block past the fused pass's memory budget takes the JAX package's "
                "per-call loop, which is not ported yet (ROADMAP.md, open items §1: "
                "_train_loop)")
        self._train_fused()

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
        for epoch in range(self.tc.epoch):
            if t.verbose:
                print(f"Epoch: {epoch}", "-" * 30)
            t.np_rng.shuffle(sequence)
            t.state, self.meta, self.meta_opt_state = maml_epoch(
                t.state, self.meta, self.meta_opt_state, sup_block, q_block,
                np.asarray(sequence, np.int32), t.gen, self.grad_scale())
            if self.epoch_tail(epoch):
                break
