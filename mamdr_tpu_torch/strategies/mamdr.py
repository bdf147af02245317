"""MAMDR = Domain Negotiation + Domain Regularization (the flagship).

Counterpart of ``mamdr_tpu/strategies/mamdr.py`` (``__init__`` :55-105,
``_row_sharded_table_mask`` :107-119, ``_dr_parallel_eligible`` :123-225
with its mesh checks, the eval plumbing and the finetune :229-297,
``prepare_fused`` :307-418, ``run_fused_epoch`` :442-470, ``_train_fused``
:472-521 with its resume snapshot). On a trainer built on a mesh the DR
lanes are split over the data group (train/fused.py) and the merged evals
split the domains over it; the decomposition is written whole by rank 0.
State: shared weights plus per-domain specific deltas on the meta-param
subset.

Per epoch, phase 1 (DN): load shared, one full-epoch pass through the
shuffled domain sequence, then shared += (θ_final - shared) * meta_lr.
Phase 2 (DR): per query domain q, for each sampled support domain s: load
merge(shared, specific[q]); an epoch on s; an epoch on q;
specific[q] += (θ - merged) * meta_lr — run with every query domain as a
lane when eligible (train/fused.py). After each epoch: the merged
per-domain validation (domain d evaluates merge(shared, specific[d])), the
early stop and the best snapshot (best_shared, best_specific); test uses the
snapshot, and the finetune stage trains every domain from its merged best
weights with SGD (strategies/separate.py).

The batch update (``*_batch`` names), ``finetune_every_epoch``, a target
domain, a fixed train order and a train block past the fused passes'
memory budget take the per-call loop (``_train_loop``, JAX :523-614): the
same epoch over ``Trainer.fit_domain`` calls — DN through the sequence; DR
per query q with its support draws, each support run loading merge(shared,
specific[q]), an epoch on the support domain and at most
``domain_regulation_step`` steps on q, then specific[q] += (θ - merged) *
meta_lr (``scaled_add_from``), or under the batch update one
specific[q] += Σ dr_accumulate / sample_num * meta_lr; with
``finetune_every_epoch`` one more epoch on q from its merged weights, which
sets specific[q] = θ - merged. A validation with ``meta_finetune_step > 0``
is the base class's meta-finetune validation from ``t.state``.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from mamdr_tpu_torch.models.embeddings import frozen_mask
from mamdr_tpu_torch.strategies import ops
from mamdr_tpu_torch.strategies.meta_base import MetaStrategy
from mamdr_tpu_torch.strategies.separate import separate_train_val_test
from mamdr_tpu_torch.train import fused
from mamdr_tpu_torch.train.steps import make_subset_train_step
from mamdr_tpu_torch.utils import trace, trees


class MAMDRStrategy(MetaStrategy):
    def __init__(self, trainer):
        super().__init__(trainer)
        self.shared = trainer.state.params
        # Only masked leaves of a specific tree are ever read, so unmasked
        # leaves alias the shared tree's tensors instead of holding their own
        # (n_domain copies of the frozen tables would not fit). Safe because
        # no update writes a tensor in place (strategies/ops.py).
        m, device = self.mask, trainer.device

        def strip(fresh):
            return trees.tree_map(
                lambda mm, f, s: f.to(device, copy=True) if mm else s,
                m, fresh, self.shared)

        if self.tc.specific_init == "zeros":
            zeros = trees.tree_map(lambda mm, s: s.new_zeros(s.shape) if mm else s,
                                   m, self.shared)
            self.specific: List = [zeros for _ in range(self.n_domain)]
        else:
            self.specific = [
                strip(trainer.fresh_params(seed=trainer.dataset.seed + 1 + i))
                for i in range(self.n_domain)
            ]
        self.best_shared = self.shared
        self.best_specific = list(self.specific)
        # The fused epoch covers the shipped DN+DR recipe; the per-call loop
        # takes the other variants.
        self.use_fused = (
            not self.spec.batch_update
            and not self.tc.finetune_every_epoch
            and self.target_domain < 0
            and trainer.fused_padding_ok(ragged=True)
        )
        self._eval_merged = None

    def _row_sharded_table_mask(self):
        """Bool tree over params: the tables this rank holds a row shard of
        (JAX :107-119, the mesh lookup's own predicate on the padded
        shapes; trainable ones included). All False without a mesh."""
        return trees.tree_map(lambda a: a == -2, self.trainer.shard_axes)

    def _dr_parallel_eligible(self) -> bool:
        """Gate for the query-domain-lanes DR phase (fused.make_fused_dr_parallel).

        The lanes need (a) no batch statistics (STAR's norms): they chain
        through the query domains in the sequential phase, and lanes would
        keep only one lane's (JAX mamdr.py:143-150); (b) the meta mask to
        cover EVERY trainable leaf — a trainable leaf outside it would need
        the sequential phase's lineage too (STAR's specific kernels under
        meta_parms ["emb", "kernel_shared", "bias_shared"]); and (c) under "auto" the lane state (params + 2 Adam slots
        per trainable leaf, every leaf of the model's tree counted — PLE's
        expert kernels, the linear tables — times n_domain) to stay under
        40% of the card's free memory — with trainable tables the lanes
        stack whole tables; ``dr_lane_chunk`` C > 0 bounds the lanes that
        exist at once to C, so the budget counts min(n_domain, C) of them
        (JAX mamdr.py:204-208). The budget counts no activations: an autograd
        lane step also holds the forward's intermediates for its backward,
        and for the MTL bases they outweigh the parameters (PLE's at bench
        shapes are [30 lanes, 30 tasks, 3 experts, 1024, 512] float32, about
        5.7 GB each), so the gate does not keep such a step inside the card.
        The budget is not checked on the CPU. "on"
        raises with the reason when (a) or (b) fails. The lane step is K1-lanes
        for the plain MLP and the autograd lane step for any other base
        model or the uncertainty-weighted loss.
        """
        mode = self.tc.dr_parallel
        if mode not in ("auto", "on", "off"):
            raise ValueError(f"dr_parallel must be auto, on or off, got {mode!r}")
        if mode == "off":
            return False
        mesh = self.trainer.mesh
        if mesh is not None:  # each group's lanes split over the data axis (JAX :151-178)
            why = None
            if self.n_domain % mesh.data:
                why = f"n_domain {self.n_domain} does not divide the mesh data axis {mesh.data}"
            elif self.tc.dr_lane_chunk > 0 and self.tc.dr_lane_chunk % mesh.data:
                why = (f"dr_lane_chunk {self.tc.dr_lane_chunk} does not divide the mesh "
                       f"data axis {mesh.data}")
            if why is not None:
                if mode == "on":
                    raise ValueError(f"dr_parallel='on' but {why}")
                return False
        if self.trainer.state.batch_stats:
            if mode == "on":
                raise ValueError(
                    "dr_parallel='on' but the model carries batch statistics (e.g. "
                    "PartitionedNorm), whose cross-query lineage needs the sequential "
                    "dr_phase")
            return False
        params = self.trainer.state.params
        frozen = self.trainer.frozen_mask()
        uncovered = [n for (n, m), f in zip(trees.leaves_with_names(self.mask),
                                            trees.leaves(frozen)) if not (m or f)]
        if uncovered:
            if mode == "on":
                raise ValueError(
                    "dr_parallel='on' but the meta mask does not cover every "
                    f"trainable leaf (uncovered: {uncovered}); non-meta trainables "
                    "need the sequential chained lineage")
            return False
        if mode == "on" or self.trainer.device.type != "cuda":
            return True
        trainable_bytes = sum(
            x.numel() * x.element_size()
            for x, f in zip(trees.leaves(params), trees.leaves(frozen)) if not f)
        concurrent = self.n_domain
        if self.tc.dr_lane_chunk > 0:
            concurrent = min(concurrent, self.tc.dr_lane_chunk)
        if mesh is not None:  # a rank holds its lanes only (JAX :209-216)
            concurrent = concurrent / mesh.data
        free_bytes, _ = torch.cuda.mem_get_info(self.trainer.device)
        return 3 * concurrent * trainable_bytes < 0.4 * free_bytes

    def _lane_chunk(self) -> int:
        """The DR lanes' group size (JAX mamdr.py:370-401): ``dr_lane_chunk``
        when set; else 7 when the user and item tables train (the lanes then
        stack whole tables) and there are more than 7 domains; else 0, every
        lane at once. On a mesh the 7 becomes max((7 // data) * data,
        data), a multiple of the data axis (JAX :397-401). Chunked and whole
        lanes give the same results, so the rule moves memory and launches,
        never a number."""
        if self.tc.dr_lane_chunk > 0:
            return self.tc.dr_lane_chunk
        trainable_table = self.tc.emb_trainable and any(
            trees.leaves(frozen_mask(self.trainer.state.params, False)))
        if not (trainable_table and self.n_domain > 7):
            return 0
        data = 1 if self.trainer.mesh is None else self.trainer.mesh.data
        return max((7 // data) * data, data)

    def prepare_fused(self) -> None:
        """Build the device-resident data block and the two phase functions;
        ``self.dr_lanes`` says whether DR runs as lanes, and
        ``_dr_lane_chunk_effective`` in groups of how many (0: all at once)."""
        t = self.trainer
        self._block, n_steps = t.train_block()
        batch, steps_list = t.dataset.batch_size, t.steps_per_domain()
        method, reg_step = self.tc.merged_method, self.tc.domain_regulation_step
        self._dn_phase, self._dr_phase = fused.make_fused_mamdr(
            t.train_step_fn(), self.mask, method, n_steps, batch, reg_step,
            steps_list=steps_list)
        self.dr_lanes = self._dr_parallel_eligible()
        self._dr_lane_chunk_effective = 0
        if self.dr_lanes:
            sub_step, to_sub, combine = make_subset_train_step(
                t.model, t.tx, t.step_cfg, self.trainer.frozen_mask(), t.state.params)
            self._dr_lane_chunk_effective = self._lane_chunk()
            self._dr_phase = fused.make_fused_dr_parallel(
                sub_step, to_sub, combine, self.mask, method, n_steps, batch,
                reg_step, steps_list=steps_list, lane_chunk=self._dr_lane_chunk_effective,
                mesh=t.mesh)
        self._spec_stack = fused.stack_specific(self.specific, self.mask)
        self._rows = [s.n for s in t.dataset.train]

    def draw_epoch(self):
        """The epoch's host draws from np_rng, exactly as the JAX package's
        run_fused_epoch makes them (mamdr.py:447-459): the shuffled domain
        order, then each query domain's support (aux) domains."""
        t = self.trainer
        sequence = self.meta_sequence()
        if self.tc.shuffle_sequence:
            t.np_rng.shuffle(sequence)
        order = np.asarray(sequence, np.int32)
        k = self.tc.sample_num
        aux_rows = []
        for q in sequence:
            cand = [d for d in sequence if d != q]
            row = list(t.np_rng.choice(cand, size=min(k, len(cand)), replace=False))
            if self.tc.add_query_domain:
                row.append(q)
            aux_rows.append(row)
        return order, np.asarray(aux_rows, np.int32)

    def _start_dn_phase(self) -> torch.Tensor:
        """The epoch's draws, then the DN phase; returns its per-position
        mean train losses, still on the device."""
        t = self.trainer
        with trace.span("strategy.draw"):
            self.order, self.aux = self.draw_epoch()
        with trace.span("strategy.dn_phase"):
            t.state, self.shared, losses = self._dn_phase(
                t.state, self.shared, self._block, self.order, t.gen,
                float(self.tc.meta_learning_rate))
        trace.count("examples.dn", sum(self._rows[d] for d in self.order))
        return losses

    @staticmethod
    def _read(losses: torch.Tensor) -> np.ndarray:
        """The losses on the host: the host sync of a phase or an epoch."""
        with trace.span("strategy.sync"):
            return trace.to_host(losses)

    def run_dn_phase(self) -> np.ndarray:
        """One epoch's draws, then the DN phase. Returns the per-position
        mean train losses; reading them is the phase's only host sync."""
        return self._read(self._start_dn_phase())

    def run_dr_phase(self) -> None:
        """The DR phase on the draws of the last DN phase; then ``specific``
        is refreshed from the stack. No host sync."""
        t = self.trainer
        with trace.span("strategy.dr_phase"):
            t.state, self._spec_stack = self._dr_phase(
                t.state, self.shared, self._spec_stack, self._block, self.order,
                self.aux, t.gen, float(self.tc.meta_learning_rate))
            self.specific = fused.unstack_specific(self._spec_stack, self.mask, self.n_domain)
        cap, batch = self.tc.domain_regulation_step, self.trainer.dataset.batch_size
        trace.count("examples.dr", sum(
            self._rows[s] + (self._rows[q] if cap <= 0 else min(cap * batch, self._rows[q]))
            for q, row in zip(self.order, self.aux) for s in row))

    def run_fused_epoch(self) -> np.ndarray:
        """One MAMDR epoch: the draws, the DN phase, the DR phase. Returns
        the DN phase's losses; reading them, after both phases are enqueued,
        is the epoch's only host sync."""
        losses = self._start_dn_phase()
        self.run_dr_phase()
        return self._read(losses)

    # ---------------- eval plumbing ----------------

    def _merged(self, shared, specific, idx: int):
        merged = ops.merge_weights(shared, specific[idx], self.mask, self.tc.merged_method)
        return ops.load_masked(self.trainer.state.params, merged, self.mask)

    def val_params_fn(self, idx: int):
        return self._merged(self.shared, self.specific, idx)

    def _best_params_fn(self, idx: int):
        """Domain d's merged best weights over the trainer's state as it is
        when called (the finetune's start)."""
        return self._merged(self.best_shared, self.best_specific, idx)

    def _merged_eval(self, mode: str, shared, specific_list):
        """Every domain with its merged weights, as one lane eval
        (fused.make_fused_eval_merged); one host read of the [D] results.
        The batch statistics are the trainer's current ones, whatever
        snapshot the weights come from (JAX mamdr.py:227-259): test and the
        finetune read the end-of-training statistics."""
        t = self.trainer
        if self._eval_merged is None:
            self._eval_merged = fused.make_fused_eval_merged(
                t.model, t.step_cfg, self.mask, self.tc.merged_method)
        spec_stack = fused.stack_specific(specific_list, self.mask)
        losses, aucs = self._eval_merged(t.state.params, shared, spec_stack,
                                         t.eval_block(mode), stats=t.state.batch_stats)
        return t.summarize(mode, *t.domain_dicts(losses, aucs))

    def validate(self):
        if self.tc.meta_finetune_step > 0:
            return super().validate()
        if self.trainer.verbose:
            print("Val Result: ")
        return self._merged_eval("val", self.shared, self.specific)

    def save_best(self) -> None:
        """Snapshot (shared, specific) on the device, write the full params
        and the decomposition (specific files hold only the masked leaves)."""
        t = self.trainer
        self.best_shared = self.shared
        self.best_specific = list(self.specific)
        t.save_checkpoint()
        t.save_decomposition(t.checkpoint_dir + "/decomposition", self.best_shared,
                             self.best_specific, {"merged_method": self.tc.merged_method},
                             self.mask)

    def test(self):
        return self._merged_eval("test", self.best_shared, self.best_specific)

    def finetune(self):
        """Every domain from merge(best_shared, best_specific[d]) with SGD
        (reference specific_base_model.py:99-162), as lanes."""
        return separate_train_val_test(self.trainer, init_params=False,
                                       params_fn=self._best_params_fn)

    # ---------------- training ----------------

    def train(self) -> None:
        if self.use_fused:
            self._train_fused()
        else:
            self._train_loop()

    def _train_fused(self) -> None:
        """tc.epoch fused epochs, each followed by the validation, early stop
        and best snapshot (epoch_tail), then every ``resume_every`` epochs
        the resume snapshot: the trainer's, with shared, the specific stack
        and the best snapshot (JAX mamdr.py:478-515). With ``train.resume``
        the loop goes on from it: the epoch's draws restart from the
        restored ``np_rng``, so a resumed run equals an unbroken one."""
        t = self.trainer
        self.prepare_fused()
        start_epoch = 0
        resumed = t.try_resume({"shared": self.shared, "spec_stack": self._spec_stack,
                                "best_shared": self.best_shared,
                                "best_spec_stack": self._spec_stack})
        if resumed is not None:
            start_epoch, ex = resumed
            self.shared = ex.get("shared", self.shared)
            self._spec_stack = ex.get("spec_stack", self._spec_stack)
            self.best_shared = ex.get("best_shared", self.best_shared)
            if "best_spec_stack" in ex:
                self.best_specific = fused.unstack_specific(ex["best_spec_stack"], self.mask,
                                                            self.n_domain)
            self.specific = fused.unstack_specific(self._spec_stack, self.mask, self.n_domain)
        for epoch in t.epochs(start_epoch):
            if t.verbose:
                print(f"Epoch: {epoch}", "-" * 30)
            self.run_fused_epoch()
            if self.epoch_tail(epoch):
                break
            if t.resume_due(epoch):
                t.save_resume_state(epoch, extra_trees={
                    "shared": self.shared, "spec_stack": self._spec_stack,
                    "best_shared": self.best_shared,
                    "best_spec_stack": fused.stack_specific(self.best_specific, self.mask)})

    def _train_loop(self) -> None:
        t = self.trainer
        m, method = self.mask, self.tc.merged_method
        sequence = self.meta_sequence()
        meta_lr = float(self.tc.meta_learning_rate)
        batch_mode = self.spec.batch_update
        for epoch in t.epochs():
            if t.verbose:
                print(f"Epoch: {epoch}", "-" * 30)
            if self.tc.shuffle_sequence:
                t.np_rng.shuffle(sequence)

            # phase 1: DN on shared
            t.state = t.state.replace(params=ops.load_masked(t.state.params, self.shared, m))
            for idx in sequence:
                t.state, _ = t.fit_domain(t.state, idx)
            self.shared = ops.reptile_update(self.shared, t.state.params, meta_lr, m)

            # phase 2: DR on specific
            for idx in sequence:
                candidates = [d for d in sequence if d != idx]
                aux_idxs = list(t.np_rng.choice(
                    candidates, size=min(self.tc.sample_num, len(candidates)), replace=False))
                if self.tc.add_query_domain:
                    aux_idxs.append(idx)
                merged = ops.merge_weights(self.shared, self.specific[idx], m, method)
                acc = (trees.tree_map(lambda mm, x: torch.zeros_like(x) if mm else x,
                                      m, self.shared) if batch_mode else None)
                for aux_idx in aux_idxs:
                    if t.verbose:
                        print(f"Support Domain: {aux_idx}, Query Domain: {idx}")
                    t.state = t.state.replace(params=ops.load_masked(t.state.params, merged, m))
                    t.state, _ = t.fit_domain(t.state, int(aux_idx))  # the support epoch
                    t.state, _ = t.fit_domain(t.state, idx,  # the query, capped
                                              max_steps=self.tc.domain_regulation_step)
                    if batch_mode:
                        acc = ops.dr_accumulate(acc, t.state.params, merged, self.shared, m,
                                                method)
                    else:
                        self.specific[idx] = self.scaled_add_from(
                            self.specific[idx], t.state.params, merged, meta_lr)
                        merged = ops.merge_weights(self.shared, self.specific[idx], m, method)
                if batch_mode:
                    self.specific[idx] = ops.scaled_add(self.specific[idx], acc,
                                                        meta_lr / self.tc.sample_num, m)
                if self.tc.finetune_every_epoch:
                    merged = ops.merge_weights(self.shared, self.specific[idx], m, method)
                    t.state = t.state.replace(params=ops.load_masked(t.state.params, merged, m))
                    t.state, loss = t.fit_domain(t.state, idx)
                    if t.verbose:
                        print(f"Train on: Domain {idx}, Loss: {float(trace.to_host(loss)):.4f}")
                    self.specific[idx] = ops.specific_from_adapted(
                        t.state.params, merged, self.specific[idx], m)
            if self.epoch_tail(epoch):
                break

    def scaled_add_from(self, specific, adapted, merged, lr):
        """specific += (adapted - merged) * lr on masked leaves (reference
        mamdr.py:173-180, merged as the base; JAX :601-614)."""
        return ops.specific_update(specific, adapted, merged, lr, self.mask)
