"""Shared layers of the CTR towers, as torch modules with flax's parameter tree.

Counterparts of ``mamdr_tpu/models/layers.py``: Dense (glorot-uniform
kernel, zero bias), DNN = [Dense -> relu -> dropout]*, FastDropout (hash
masks, ops.fast_random) and the bias-free glorot-normal logit head
(reference model_zoo/DeepCTR/deepctr.py:118-136).

Modules are nested so that parameter paths equal the flax names: the zoo's
``Dense`` wraps flax's ``nn.Dense`` as ``Dense_0``, so a DNN layer's kernel is
``dnn/Dense_i/Dense_0/kernel``. Kernels are stored ``[in, out]`` as flax
stores them, so converting between the two frameworks never transposes.
Initialisation draws from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn

from mamdr_tpu_torch.ops.fast_random import dropout_mask


def glorot_uniform(t: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    fan_in, fan_out = t.shape[-2], t.shape[-1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return t.uniform_(-limit, limit, generator=generator)


def glorot_normal(t: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's glorot_normal: variance_scaling(1, fan_avg, truncated_normal)."""
    fan_in, fan_out = t.shape[-2], t.shape[-1]
    # stddev of a unit normal truncated to [-2, 2]
    std = math.sqrt(2.0 / (fan_in + fan_out)) / 0.87962566103423978
    return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def emb_init(t: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """deepctr SparseFeat default: RandomNormal(stddev=1e-4)."""
    return t.normal_(0.0, 1e-4, generator=generator)


class _FlaxDense(nn.Module):
    """flax.linen.Dense: y = x @ kernel (+ bias), kernel [in, out]."""

    def __init__(self, in_features: int, features: int, use_bias: bool,
                 kernel_init: Callable, generator: Optional[torch.Generator]):
        super().__init__()
        self.kernel = nn.Parameter(kernel_init(torch.empty(in_features, features), generator))
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(features))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.kernel
        if self.bias is not None:
            y = y + self.bias
        return y


class Dense(nn.Module):
    """Keras-default Dense: glorot_uniform kernel, zero bias."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 kernel_init: Callable = glorot_uniform,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Dense_0 = _FlaxDense(in_features, features, use_bias, kernel_init, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_0(x)


class FastDropout(nn.Module):
    """Inverted dropout with a counter-based hash mask (ops.fast_random).

    The seed is passed in per call (a uint32 value); without one the layer
    is the identity (evaluation).
    """

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, seed=None) -> torch.Tensor:
        if seed is None or self.rate <= 0.0:
            return x
        keep = dropout_mask(seed, self.rate, x.shape, device=x.device)
        return torch.where(keep, x / (1.0 - self.rate), 0.0)


class DNN(nn.Module):
    """deepctr layers.core.DNN: stacked Dense -> relu -> dropout."""

    def __init__(self, in_features: int, hidden_units: Sequence[int],
                 dropout_rate: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_layers = len(hidden_units)
        prev = in_features
        for i, units in enumerate(hidden_units):
            setattr(self, f"Dense_{i}", Dense(prev, units, generator=generator))
            prev = units
        self.dropout = FastDropout(dropout_rate)

    def forward(self, x: torch.Tensor, seeds=None) -> torch.Tensor:
        """seeds: one uint32 dropout seed per layer, or None (no dropout)."""
        for i in range(self.n_layers):
            x = torch.relu(getattr(self, f"Dense_{i}")(x))
            x = self.dropout(x, None if seeds is None else seeds[i])
        return x


class LogitDense(nn.Module):
    """Final 1-unit logit head: Dense(1, use_bias=False, glorot_normal)."""

    def __init__(self, in_features: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Dense_0 = Dense(in_features, 1, use_bias=False,
                             kernel_init=glorot_normal, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_0(x)[..., 0]
