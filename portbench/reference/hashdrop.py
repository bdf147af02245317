"""Frozen copy of the hash-dropout arithmetic (murmur3 fmix32 over a counter).

The benchmark's own copy, so that a later change to the program cannot move
the yardstick: a flat row-major uint32 counter times 2654435761 plus the
seed, through the murmur3 finaliser, the top 24 bits as a uniform in
[0, 1); an element is kept where that uniform is at least the rate. Step
seeds are fmix32((step * n_layers + layer) * golden + base), and lane base
seeds fmix32(lane * 0xC2B2AE3D + base). Seeds are python ints here (no
device copy a step); the masks are torch tensors on the caller's device.
"""

from __future__ import annotations

from typing import List

import torch

MASK32 = 0xFFFFFFFF
IOTA_MUL = 2654435761
MUL1 = 0x85EBCA6B
MUL2 = 0xC2B2AE35
GOLDEN = 0x9E3779B9
LANE_MUL = 0xC2B2AE3D


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32): the constant split in
    16-bit halves so that no product leaves int64."""
    hi, lo = c >> 16, c & 0xFFFF
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = mul32(x, MUL1)
    x = x ^ (x >> 13)
    x = mul32(x, MUL2)
    return x ^ (x >> 16)


def fmix32_int(x: int) -> int:
    x &= MASK32
    x ^= x >> 16
    x = (x * MUL1) & MASK32
    x ^= x >> 13
    x = (x * MUL2) & MASK32
    return x ^ (x >> 16)


def step_seeds(base: int, step: int, n_layers: int) -> List[int]:
    """The dropout seed of each layer at train step ``step``."""
    return [fmix32_int((((step * n_layers + i) & MASK32) * GOLDEN + base) & MASK32)
            for i in range(n_layers)]


def lane_seeds(base: int, n_lanes: int) -> List[int]:
    """Each lane's base seed."""
    return [fmix32_int(((lane * LANE_MUL) & MASK32) + (base & MASK32)) for lane in range(n_lanes)]


class KeepMasks:
    """Keep masks of one shape, [rows, width], for any seeds: the counter's
    product is made once and each mask costs the finaliser alone."""

    def __init__(self, rows: int, width: int, rate: float, device):
        self.shape = (rows, width)
        self.rate = rate
        idx = torch.arange(rows * width, dtype=torch.int64, device=device)
        self.base = mul32(idx, IOTA_MUL)

    def many(self, seeds: List[int]) -> torch.Tensor:
        """[len(seeds), rows, width] keep masks, one a seed."""
        s = torch.tensor([v & MASK32 for v in seeds], dtype=torch.int64, device=self.base.device)
        x = fmix32((self.base[None, :] + s[:, None]) & MASK32)
        u = (x >> 8).to(torch.float32) * (1.0 / (1 << 24))
        return (u >= self.rate).reshape(len(seeds), *self.shape)
