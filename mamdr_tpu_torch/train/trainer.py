"""Trainer: model, optimizer, state and device-resident data, wired together.

Counterpart of the construction path of ``mamdr_tpu/train/trainer.py``
(``Trainer.__init__`` for the single-device case, ``train_block``,
``steps_per_domain``). Evaluation, checkpoints and the finetune stage are
later slices.

Randomness is explicit: ``np_rng`` (numpy, seeded by the dataset seed) makes
the host-side draws the JAX package makes with numpy — domain order, aux
domains — so both packages draw the same values; a CPU ``torch.Generator``
seeds parameter init and the base dropout seed; ``gen``, a generator on the
run's device, makes the batch shuffles.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from mamdr_tpu_torch import DeviceLike, resolve_device
from mamdr_tpu_torch.config import ExperimentConfig
from mamdr_tpu_torch.data.dataset import MultiDomainDataset
from mamdr_tpu_torch.models.zoo import build_model
from mamdr_tpu_torch.train import fused
from mamdr_tpu_torch.train.state import TrainState
from mamdr_tpu_torch.train.steps import StepConfig, make_optimizer, make_train_step
from mamdr_tpu_torch.utils import trees


class Trainer:
    def __init__(self, config: ExperimentConfig, dataset: MultiDomainDataset,
                 device: DeviceLike = None):
        """device: None runs on the CUDA card (and raises without one);
        "cpu" runs the plain versions of the kernels on the CPU."""
        self.device = resolve_device(device)
        self.config = config
        self.dataset = dataset
        tc = config.train

        self.np_rng = np.random.default_rng(dataset.seed)
        init_gen = torch.Generator().manual_seed(dataset.seed)
        self.model = self._build_model(init_gen)
        params = {"model": trees.tree_map(
            lambda p: p.to(self.device, copy=True), self.model.param_tree())}
        dropout_seed = int(torch.randint(0, 2**32, (), generator=init_gen,
                                         dtype=torch.int64))
        self.gen = torch.Generator(device=self.device).manual_seed(dataset.seed)

        self.step_cfg = StepConfig(l2_emb=1e-5, emb_trainable=tc.emb_trainable)
        self.tx = make_optimizer(tc.optimizer, tc.learning_rate, params,
                                 tc.emb_trainable, flat=tc.flat_optimizer)
        self.state = TrainState.create(params, self.tx.init(params), dropout_seed,
                                       self.device)
        self._train_block: Optional[Tuple[Dict[str, torch.Tensor], int]] = None

    def _build_model(self, generator: torch.Generator):
        ds = self.dataset
        return build_model(self.config, n_uid=ds.n_uid, n_pid=ds.n_pid,
                           n_domain=ds.n_domain, pretrained_user=ds.user_emb,
                           pretrained_item=ds.item_emb, generator=generator)

    def fresh_params(self, seed: int):
        """A fresh random draw of the full parameter tree, on the CPU
        (pretrained tables are the dataset's buffers, not copies). MAMDR's
        per-domain specific init re-runs the initialisers per domain
        (reference mamdr.py:30-33)."""
        model = self._build_model(torch.Generator().manual_seed(seed))
        return {"model": model.param_tree()}

    def train_block(self):
        """Device-resident ({col: [D, N_pad]}, n_steps) train block."""
        if self._train_block is None:
            self._train_block = fused.stack_domains_on_device(
                self.dataset.train, self.dataset.batch_size, self.device)
        return self._train_block

    def steps_per_domain(self) -> List[int]:
        """Per-domain real step counts ceil(n_d / B)."""
        return fused.domain_step_counts(self.dataset.train, self.dataset.batch_size)

    def train_step_fn(self):
        return make_train_step(self.model, self.tx, self.step_cfg)
