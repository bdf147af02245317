"""MAMDR = Domain Negotiation + Domain Regularization (the flagship).

Counterpart of the construction path and the DN phase of
``mamdr_tpu/strategies/mamdr.py`` (``__init__`` :55-96, ``prepare_fused``
:307-333, the draws and DN half of ``run_fused_epoch`` :442-467). State:
shared weights plus per-domain specific deltas on the meta-param subset.

Per epoch, phase 1 (DN): load shared, one full-epoch pass through the
shuffled domain sequence, then shared += (θ_final - shared) * meta_lr.
Phase 2 (DR), evaluation and the finetune stage are later slices.
"""

from __future__ import annotations

from typing import List

import numpy as np

from mamdr_tpu_torch.strategies.meta_base import MetaStrategy
from mamdr_tpu_torch.train import fused
from mamdr_tpu_torch.utils import trees


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

    def prepare_fused(self) -> None:
        """Build the device-resident data block and the DN phase function."""
        t = self.trainer
        self._block, n_steps = t.train_block()
        self._dn_phase = fused.make_fused_mamdr(
            t.train_step_fn(), self.mask, n_steps, t.dataset.batch_size,
            steps_list=t.steps_per_domain(),
        )

    def draw_epoch(self):
        """The epoch's host draws from np_rng, exactly as the JAX package's
        run_fused_epoch makes them (mamdr.py:447-459): the shuffled domain
        order, then each query domain's support (aux) domains. The DR phase
        consumes the aux rows; drawing them here keeps the numpy stream in
        step with the JAX package's."""
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

    def run_dn_phase(self) -> np.ndarray:
        """One epoch's draws, then the DN phase. Returns the per-position
        mean train losses; reading them is the phase's only host sync."""
        t = self.trainer
        self.order, self.aux = self.draw_epoch()
        t.state, self.shared, losses = self._dn_phase(
            t.state, self.shared, self._block, self.order, t.gen,
            float(self.tc.meta_learning_rate),
        )
        return losses.cpu().numpy()
