"""Train state: the whole mutable world of a run, as one explicit value.

Counterpart of ``mamdr_tpu/train/state.py``. The JAX state carries a PRNG key
folded per step; the port carries a base dropout seed (a python int drawn
once from the Trainer's generator) and derives per-step seeds on the device
from it and ``step`` (ops.fast_random.step_seeds). Updates are functional:
a train step returns a new state and never writes a tensor of the old one.

``batch_stats`` is flax's collection of the same name: the moving
statistics of a model with a norm (STAR's PartitionedNorm / BatchNorm,
``model.init_stats()``), ``{}`` for every other model. A train step returns
them updated, and the eval reads them.

A lane-stacked state (the DR phase's query-domain lanes, the finetune
lanes) is the same struct with a leading lane axis on every trainable leaf
and optimizer slot, ``step`` [L], ``seed`` an [L] tensor of per-lane base
seeds, and ``batch_stats`` [L]-stacked.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Union

import torch


@dataclasses.dataclass(frozen=True)
class TrainState:
    params: Any          # {'model': flax-named nested dict of tensors}
    opt_state: Any
    seed: Union[int, torch.Tensor]  # base dropout seed (uint32 value); [L] over lanes
    step: torch.Tensor   # int32 on the device: train steps taken (scalar, or [L])
    batch_stats: Any = dataclasses.field(default_factory=dict)  # {} without a norm

    @classmethod
    def create(cls, params, opt_state, seed: int, device, batch_stats=None) -> "TrainState":
        return cls(params=params, opt_state=opt_state, seed=int(seed),
                   step=torch.zeros((), dtype=torch.int32, device=device),
                   batch_stats={} if batch_stats is None else batch_stats)

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)
