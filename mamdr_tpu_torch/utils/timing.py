"""Timing on the card: CUDA-graph replay, eager launch, and the card's line.

Used by chip_smoke.py, probe_gather.py and kernel_profile.py. Every function
needs a CUDA card; none falls back to the CPU. The program's own spans, which
a device trace of a real run shows, are utils/trace.py's (``train.profile_dir``).
"""

from __future__ import annotations

import subprocess
from typing import Callable

import torch


def card_line() -> str:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
    them (first card)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def device_ms(fn: Callable[[], object], inner: int = 20, reps: int = 5) -> float:
    """Device milliseconds per call of fn: `inner` calls captured in a CUDA
    graph, replayed `reps` times between CUDA events (no host overhead)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * inner)


def eager_ms(fn: Callable[[], object], iters: int = 50) -> float:
    """Milliseconds per call launched one by one from the host (what the train
    loop sees), between CUDA events after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters
