"""Shared layers of the CTR towers, as torch modules with flax's parameter tree.

Counterparts of ``mamdr_tpu/models/layers.py``: Dense (glorot-uniform
kernel, zero bias), DNN = [Dense -> relu -> dropout]*, FastDropout (hash
masks, ops.fast_random), the bias-free glorot-normal logit head
(reference model_zoo/DeepCTR/deepctr.py:118-136), and the interaction
layers of the zoo: ``fm_interaction``, ``bi_interaction``,
``inner_product``, ``OuterProduct``, ``InteractingLayer``, ``k_max_pooling``
and ``Conv`` (flax ``nn.Conv`` over the field axis, for CCPM).

A Dense, DNN or logit head built with a compute ``dtype`` (the models'
``compute_dtype`` "bfloat16") computes as flax ``nn.Dense(dtype=...)`` does:
input, kernel and bias promoted to that dtype, the product and the bias
added in it, the ReLU and the dropout (``x / (1 - rate)`` too) after it in
it; the logit head returns float32. The parameters stay float32.

Modules are nested so that parameter paths equal the flax names: the zoo's
``Dense`` wraps flax's ``nn.Dense`` as ``Dense_0``, so a DNN layer's kernel is
``dnn/Dense_i/Dense_0/kernel``. Kernels are stored ``[in, out]`` as flax
stores them (a conv kernel HWIO), so converting between the two frameworks
never transposes. Initialisation draws from an explicit ``torch.Generator``
with flax's ``variance_scaling`` fans: for a kernel of rank above 2 both fans
carry the receptive field ``prod(shape[:-2])`` (``fans``).
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch
from torch import nn

from mamdr_tpu_torch.ops.fast_random import dropout_mask

# stddev of a unit normal truncated to [-2, 2]: flax's truncated_normal
# variance_scaling divides by it so the draw keeps the asked-for variance
_TRUNC_STD = 0.87962566103423978


def fans(shape: Sequence[int]) -> Tuple[int, int]:
    """flax ``variance_scaling``'s (fan_in, fan_out) for a kernel whose input
    axis is -2 and output axis -1: each times the receptive field, the
    product of the other axes (1 for a rank-2 kernel)."""
    shape = tuple(int(s) for s in shape)
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def _trunc_normal(t: torch.Tensor, std: float, generator) -> torch.Tensor:
    std = std / _TRUNC_STD
    return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def glorot_uniform(t: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's glorot_uniform: variance_scaling(1, fan_avg, uniform)."""
    fan_in, fan_out = fans(t.shape)
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return t.uniform_(-limit, limit, generator=generator)


def glorot_normal(t: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's glorot_normal: variance_scaling(1, fan_avg, truncated_normal)."""
    fan_in, fan_out = fans(t.shape)
    return _trunc_normal(t, math.sqrt(2.0 / (fan_in + fan_out)), generator)


def lecun_normal(t: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's lecun_normal (``nn.Conv``'s default kernel init):
    variance_scaling(1, fan_in, truncated_normal)."""
    fan_in, _ = fans(t.shape)
    return _trunc_normal(t, math.sqrt(1.0 / fan_in), generator)


def emb_init(t: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """deepctr SparseFeat default: RandomNormal(stddev=1e-4)."""
    return t.normal_(0.0, 1e-4, generator=generator)


def dense_dtype(name: str) -> Optional[torch.dtype]:
    """A config's ``compute_dtype`` as the dtype a Dense computes in: None
    for "float32" (no cast), else the torch dtype of that name."""
    if name == "float32":
        return None
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"compute_dtype {name!r} is not a floating-point dtype")
    return dtype


class _FlaxDense(nn.Module):
    """flax.linen.Dense: y = x @ kernel (+ bias), kernel [in, out]; with a
    ``dtype``, x, kernel and bias cast to it first (flax's promote_dtype)."""

    def __init__(self, in_features: int, features: int, use_bias: bool,
                 kernel_init: Callable, generator: Optional[torch.Generator],
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(kernel_init(torch.empty(in_features, features), generator))
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(features))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kernel, bias = self.kernel, self.bias
        if self.dtype is not None:
            x, kernel = x.to(self.dtype), kernel.to(self.dtype)
            bias = None if bias is None else bias.to(self.dtype)
        y = x @ kernel
        if bias is not None:
            y = y + bias
        return y


class Dense(nn.Module):
    """Keras-default Dense: glorot_uniform kernel, zero bias."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 kernel_init: Callable = glorot_uniform,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.Dense_0 = _FlaxDense(in_features, features, use_bias, kernel_init, generator,
                                  dtype)

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
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_layers = len(hidden_units)
        prev = in_features
        for i, units in enumerate(hidden_units):
            setattr(self, f"Dense_{i}", Dense(prev, units, generator=generator, dtype=dtype))
            prev = units
        self.dropout = FastDropout(dropout_rate)

    def forward(self, x: torch.Tensor, seeds=None) -> torch.Tensor:
        """seeds: one uint32 dropout seed per layer, or None (no dropout)."""
        for i in range(self.n_layers):
            x = torch.relu(getattr(self, f"Dense_{i}")(x))
            x = self.dropout(x, None if seeds is None else seeds[i])
        return x


class LogitDense(nn.Module):
    """Final 1-unit logit head: Dense(1, use_bias=False, glorot_normal); the
    logits are float32 whatever the compute dtype."""

    def __init__(self, in_features: int, generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.Dense_0 = Dense(in_features, 1, use_bias=False,
                             kernel_init=glorot_normal, generator=generator, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_0(x)[..., 0].to(torch.float32)


def fm_interaction(fields: torch.Tensor) -> torch.Tensor:
    """FM second-order term: 0.5 * sum((sum_f v)^2 - sum_f v^2) -> [B];
    fields [B, F, D]."""
    sum_v = torch.sum(fields, dim=1)
    sum_v2 = torch.sum(fields * fields, dim=1)
    return 0.5 * torch.sum(sum_v * sum_v - sum_v2, dim=-1)


def bi_interaction(fields: torch.Tensor) -> torch.Tensor:
    """NFM bi-interaction pooling: 0.5 * ((sum v)^2 - sum v^2) -> [B, D]."""
    sum_v = torch.sum(fields, dim=1)
    sum_v2 = torch.sum(fields * fields, dim=1)
    return 0.5 * (sum_v * sum_v - sum_v2)


def _pairs(n_fields: int) -> Tuple[List[int], List[int]]:
    """jnp.triu_indices(n_fields, k=1): the field pairs (i < j) in row order."""
    pairs = [(i, j) for i in range(n_fields) for j in range(i + 1, n_fields)]
    return [i for i, _ in pairs], [j for _, j in pairs]


def inner_product(fields: torch.Tensor) -> torch.Tensor:
    """PNN inner-product layer: pairwise dots of the fields -> [B, F*(F-1)/2]."""
    rows, cols = _pairs(fields.shape[1])
    return torch.sum(fields[:, rows, :] * fields[:, cols, :], dim=-1)


class OuterProduct(nn.Module):
    """PNN outer-product layer (kernel type 'mat', deepctr's default): p^T W_ij q
    for each field pair (i, j), W ``kernel`` [P, D, D]."""

    def __init__(self, n_fields: int, dim: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rows, self.cols = _pairs(n_fields)
        self.kernel = nn.Parameter(
            glorot_uniform(torch.empty(len(self.rows), dim, dim), generator))

    def forward(self, fields: torch.Tensor) -> torch.Tensor:
        p, q = fields[:, self.rows, :], fields[:, self.cols, :]
        return torch.sum(torch.einsum("bpd,pde->bpe", p, self.kernel) * q, dim=-1)


class InteractingLayer(nn.Module):
    """AutoInt multi-head self-attention over the fields (deepctr
    InteractingLayer): per-head Q/K/V projections of ``att_embedding_size``,
    softmax(QK^T) over the fields, heads concatenated, plus the residual
    projection ``res`` (deepctr's att_res, on in every config), then relu.
    Params ``query`` / ``key`` / ``value`` / ``res`` [D_in, heads * size]."""

    def __init__(self, d_in: int, att_embedding_size: int = 8, head_num: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.size, self.heads = att_embedding_size, head_num
        unit = att_embedding_size * head_num
        for name in ("query", "key", "value", "res"):
            setattr(self, name, nn.Parameter(glorot_uniform(torch.empty(d_in, unit), generator)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, f, _ = x.shape

        def heads(t):  # [B, F, unit] -> [H, B, F, S]
            return t.reshape(b, f, self.heads, self.size).permute(2, 0, 1, 3)

        q, k, v = heads(x @ self.query), heads(x @ self.key), heads(x @ self.value)
        attn = torch.softmax(torch.einsum("hbfs,hbgs->hbfg", q, k), dim=-1)
        out = torch.einsum("hbfg,hbgs->hbfs", attn, v)
        out = out.permute(1, 2, 0, 3).reshape(b, f, self.heads * self.size)
        return torch.relu(out + x @ self.res)


def k_max_pooling(x: torch.Tensor, k: int, dim: int = 1) -> torch.Tensor:
    """CCPM's k-max pooling as ``lax.top_k`` takes it: the k largest values
    along ``dim`` in DESCENDING order (not in the fields' order)."""
    return torch.topk(x, k, dim=dim, largest=True, sorted=True).values


class Conv(nn.Module):
    """flax ``nn.Conv(features, kernel_size=(width, 1), padding="SAME")`` on
    NHWC input [B, F, D, C_in], over the field axis: ``kernel`` [width, 1,
    C_in, features] in flax's HWIO layout (lecun_normal), ``bias``
    [features] (zeros). XLA's SAME padding: (width - 1) // 2 zero rows before
    the fields and width // 2 after."""

    def __init__(self, in_features: int, features: int, width: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.width = width
        self.kernel = nn.Parameter(
            lecun_normal(torch.empty(width, 1, in_features, features), generator))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f, w = x.shape[1], self.width
        xp = nn.functional.pad(x, (0, 0, 0, 0, (w - 1) // 2, w // 2))
        taps = torch.stack([xp[:, i:i + f] for i in range(w)], dim=2)  # [B, F, W, D, C]
        return torch.einsum("bfwdc,wco->bfdo", taps, self.kernel[:, 0]) + self.bias
