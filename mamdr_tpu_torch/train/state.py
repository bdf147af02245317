"""Train state: the whole mutable world of a run, as one explicit value.

Counterpart of ``mamdr_tpu/train/state.py``. The JAX state carries a PRNG key
folded per step; the port carries a base dropout seed (a python int drawn
once from the Trainer's generator) and derives per-step seeds on the device
from it and ``step`` (ops.fast_random.step_seeds). Updates are functional:
a train step returns a new state and never writes a tensor of the old one.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class TrainState:
    params: Any          # {'model': flax-named nested dict of tensors}
    opt_state: Any
    seed: int            # base dropout seed (uint32 value)
    step: torch.Tensor   # int32 scalar on the device: train steps taken

    @classmethod
    def create(cls, params, opt_state, seed: int, device) -> "TrainState":
        return cls(params=params, opt_state=opt_state, seed=int(seed),
                   step=torch.zeros((), dtype=torch.int32, device=device))

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)
