"""The yardstick every configuration shares: the card's peaks, what a run's
work is counted in, and the optimizer pass's least bytes.

Peaks are NVIDIA's published dense rates of one H100 SXM at its 700 W
limit. A configuration's own work module (``work/<work>.py``) counts its
examples, their operations and its kernels' least times; what depends only
on the trained leaves' sizes is counted here, so that every configuration
that trains with Adam gets it alike:

- an Adam step (the program's flat Adam, its apply and the all-pad gate,
  one pass on the card) needs at least 28 bytes an element of every
  trainable leaf, in each lane that holds data: p, g, mu and nu read once,
  p', mu' and nu' written once.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

PEAK_TF32_FLOPS = 495e12  # dense TF32 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
F32 = 4
ADAM_BYTES = 7 * F32  # p, g, mu, nu read; p', mu', nu' written


def adam_least_s(elements: int, lane_steps: int) -> float:
    """Least time of ``lane_steps`` Adam lane-steps over ``elements``
    trainable elements a lane, at the HBM rate."""
    return ADAM_BYTES * elements * lane_steps / HBM_BYTES_PER_S


@dataclass
class Work:
    """What an epoch (or several) did, counted."""

    examples: int = 0
    flops: int = 0          # the model's forward and backward operations of the examples
    batches: int = 0        # steps and lane-steps
    lane_steps: int = 0     # Adam steps, a lane that holds data each
    phase_examples: Dict[str, int] = field(default_factory=dict)  # by the system's phase
    least_s: Dict[str, float] = field(default_factory=dict)       # by kernel

    def add(self, other: "Work") -> None:
        for k in ("examples", "flops", "batches", "lane_steps"):
            setattr(self, k, getattr(self, k) + getattr(other, k))
        for mine, theirs in ((self.phase_examples, other.phase_examples),
                             (self.least_s, other.least_s)):
            for k, v in theirs.items():
                mine[k] = mine.get(k, 0) + v
