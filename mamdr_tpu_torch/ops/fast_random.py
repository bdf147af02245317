"""Counter-based hash PRNG for dropout masks (murmur3 fmix32).

Bit-identical to ``mamdr_tpu/ops/fast_random.py``: a flat row-major uint32
counter times 2654435761 plus the seed, through the murmur3 finaliser, top
24 bits as a uniform in [0, 1). torch has no uint32 arithmetic to speak of,
so the values live in int64 and every product is reduced mod 2**32 by
``mul32``, which splits the multiplier so no intermediate leaves int64.

``step_seeds`` is the port's own seed source, in place of the JAX package's
``key_to_seed`` (which consumes JAX PRNG keys): per-step, per-layer uint32
seeds derived on the device from a base seed and the train state's step
counter, so a step that does not advance ``step`` (an all-pad batch) does
not advance the dropout stream either.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
IOTA_MUL = 2654435761
MUL1 = 0x85EBCA6B
MUL2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32) and a constant c < 2**32.

    c = hi * 2**16 + lo; x*lo and x*hi stay below 2**48, so nothing
    overflows int64.
    """
    hi, lo = c >> 16, c & 0xFFFF
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 on int64 tensors holding uint32 values."""
    x = x ^ (x >> 16)
    x = mul32(x, MUL1)
    x = x ^ (x >> 13)
    x = mul32(x, MUL2)
    x = x ^ (x >> 16)
    return x


def _seed_i64(seed, device) -> torch.Tensor:
    if isinstance(seed, torch.Tensor):
        return seed.to(device=device, dtype=torch.int64) & MASK32
    return torch.tensor(int(seed) & MASK32, dtype=torch.int64, device=device)


def hash_uniform(seed, shape, device=None) -> torch.Tensor:
    """Uniform [0,1) float32 of `shape` from a scalar uint32 seed."""
    n = 1
    for s in shape:
        n *= int(s)
    if device is None and isinstance(seed, torch.Tensor):
        device = seed.device
    idx = torch.arange(n, dtype=torch.int64, device=device)
    x = (mul32(idx, IOTA_MUL) + _seed_i64(seed, idx.device)) & MASK32
    x = fmix32(x)
    # 24-bit mantissa -> [0, 1)
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def dropout_mask(seed, rate: float, shape, device=None) -> torch.Tensor:
    """Keep-mask (bool) with P(keep) = 1-rate."""
    return hash_uniform(seed, shape, device).reshape(tuple(shape)) >= rate


def step_seeds(base: int, step: torch.Tensor, n_layers: int) -> torch.Tensor:
    """[n_layers] int64 tensor of uint32 dropout seeds for train step `step`.

    Computed on step's device: no host sync per step.
    """
    layer = torch.arange(n_layers, dtype=torch.int64, device=step.device)
    counter = (step.to(torch.int64) * n_layers + layer) & MASK32
    return fmix32((mul32(counter, _GOLDEN) + (int(base) & MASK32)) & MASK32)
