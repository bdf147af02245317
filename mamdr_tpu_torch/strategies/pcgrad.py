"""PCGrad: cross-domain gradient surgery.

Counterpart of ``mamdr_tpu/strategies/pcgrad.py`` (:30-91). Reference
model_zoo/pcgrad.py:16-332. Per epoch, per (shuffled) query domain:
accumulate the query domain's gradients at the current weights (at most
``meta_train_step`` batches), then for each of ``sample_num`` aux domains
drawn without replacement from the others (numpy, ``Trainer.np_rng``, one
draw per query as the JAX package makes them) accumulate a whole epoch's
gradients and project them before summing; apply the sum with the meta-Adam
(``meta_learning_rate``, MAML's). The model's own optimizer is never used.
Gradients are taken with dropout off (K1 at rate 0 on the card).

Two quirks of the reference kept in mode "reference" (``train.pcgrad_mode``):
the projection fires on dot > 0 and divides by ||g|| (pcgrad.py:152-160;
the published rule: dot < 0 and ||g||²), and each aux gradient is
projected against the RUNNING sum, not the query's (``final_grads =
current_grads`` aliases the arrays, pcgrad.py:102-103). Mode "paper" is
the published rule. A target domain, a fixed train order or a train block
past the fused pass's memory budget take the per-call loop
(``_train_loop``, JAX :93-132): each gradient pass is an
``accumulate_split`` (its own order from ``np_rng``), the aux draws
interleaved with them, the aux epochs uncapped.
"""

from __future__ import annotations

import numpy as np

from mamdr_tpu_torch.strategies import ops
from mamdr_tpu_torch.strategies.maml import MAMLStrategy
from mamdr_tpu_torch.train import fused


class PCGradStrategy(MAMLStrategy):
    def train(self) -> None:
        if self.target_domain < 0 and self.trainer.fused_padding_ok(ragged=True):
            self._train_fused()
        else:
            self._train_loop()

    def _train_fused(self) -> None:
        t = self.trainer
        # Query and aux gradients both come from the meta-split's support
        # set (reference pcgrad.py reads meta_data_split's train_iters for
        # both); train-train makes that the whole train set.
        if self.tc.meta_split == "train-train":
            block, n_steps = t.train_block()
            steps_list = t.steps_per_domain()
        else:
            supports = [self.support_query(i)[0] for i in range(self.n_domain)]
            block, n_steps = fused.stack_domains_on_device(supports, t.dataset.batch_size,
                                                           t.device)
            steps_list = fused.domain_step_counts(supports, t.dataset.batch_size)
        pcgrad_epoch = fused.make_fused_pcgrad(
            t.accum_grad_fn, self.mask, self.meta_tx, n_steps, t.dataset.batch_size,
            cap_steps=self.tc.meta_train_step, mode=self.tc.pcgrad_mode,
            steps_list=steps_list)
        sequence = self.domain_sequence()
        k = min(self.tc.sample_num, len(sequence) - 1)
        for epoch in t.epochs():
            if t.verbose:
                print(f"Epoch: {epoch}", "-" * 30)
            t.np_rng.shuffle(sequence)
            aux = np.stack([
                t.np_rng.choice([d for d in sequence if d != q], size=k, replace=False)
                for q in sequence]).astype(np.int32)
            t.state, self.meta_opt_state = pcgrad_epoch(
                t.state, self.meta_opt_state, block, np.asarray(sequence, np.int32), aux,
                t.gen, self.grad_scale())
            self.meta = t.state.params
            if self.epoch_tail(epoch):
                break

    def _train_loop(self) -> None:
        t = self.trainer
        sequence = self.domain_sequence()
        mode = self.tc.pcgrad_mode
        splits = {idx: self.support_query(idx)[0] for idx in sequence}  # drawn once
        for epoch in t.epochs():
            if t.verbose:
                print(f"Epoch: {epoch}", "-" * 30)
            t.np_rng.shuffle(sequence)
            for idx in sequence:
                params, stats = t.state.params, t.state.batch_stats
                query_grads = self.accumulate_split(
                    params, splits[idx], fused.zeros_acc(self.mask, params), stats=stats)
                running = query_grads
                candidates = [d for d in sequence if d != idx]
                aux_idxs = t.np_rng.choice(candidates,
                                           size=min(self.tc.sample_num, len(candidates)),
                                           replace=False)
                for aux_idx in aux_idxs:
                    if t.verbose:
                        print(f"Support Domain: {aux_idx}, Query Domain: {idx}")
                    # the aux domain's support split, a whole epoch (pcgrad.py:116-120)
                    aux_grads = self.accumulate_split(
                        params, splits[int(aux_idx)], fused.zeros_acc(self.mask, params),
                        cap=False, stats=stats)
                    base = running if mode == "reference" else query_grads
                    running = ops.tree_add_trees(running,
                                                 ops.pcgrad_project(base, aux_grads, mode))
                t.state = t.state.replace(params=self.meta_apply(params, running))
            self.meta = t.state.params
            if self.epoch_tail(epoch):
                break
