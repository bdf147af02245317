"""Where kernel K1's time goes: timed ablations of ``csrc/fused_mlp_step.cu``.

    python3 -m mamdr_tpu_torch.k1_ablation

On one CUDA card with ``nvcc``, from the repository root. Builds K1's source
again with one part taken out each — the weight-tile loads, two of the three
TF32 product passes, all three: the source's own ``MAMDR_K1_*`` switches,
set with ``-D`` through ``_cuda.build_variant`` — launches each build through
the package's wrapper, and prints the device microseconds of K1's two CUDA
kernels per call (``torch.profiler``) at the main path's shapes, one lane and
30 lanes, beside the unchanged build. An ablated build computes wrong
results; only its time is read. The differences say what a slab block
waits for: no profiler of the card's counters is at hand on every machine.
Then it builds and runs ``csrc/probe_tile_stream.cu``, which streams K1's
weight tiles into shared memory with nothing to compute, from one block and
from grids that cover the card: the rate all SMs get from L2 between them is
what bounds K1's weight traffic at 30 lanes. Every line names the card and
its power limit.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

# name -> nvcc switches (see csrc/fused_mlp_step.cu)
ABLATIONS = {
    "as it is": [],
    "no weight-tile loads": ["-DMAMDR_K1_NO_TILE_LOADS"],
    "one product pass of three": ["-DMAMDR_K1_FIRST_PASS=2"],
    "no product pass": ["-DMAMDR_K1_FIRST_PASS=3"],
}


def _kernel_us(fn, calls: int = 5):
    """{"slab": us, "dw": us} per call of fn, from a profile."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        for short in ("slab", "dw"):
            if short + "_kernel" in e.key:
                us = getattr(e, "self_device_time_total", None)
                out[short] = (e.self_cuda_time_total if us is None else us) / e.count
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_ablation: no CUDA card available", file=sys.stderr)
        return 1
    from mamdr_tpu_torch.ops import _cuda
    from mamdr_tpu_torch.ops import fused_mlp_step as k1
    from mamdr_tpu_torch.utils.timing import card_line

    card = card_line()
    dev = torch.device("cuda")
    dims, batch, rate = (384, 256, 128, 64), 1024, 0.5
    rng = np.random.default_rng(0)

    def operands(lanes):
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
        dense = []
        for i in range(len(dims) - 1):
            lim = np.sqrt(6.0 / (dims[i] + dims[i + 1]))
            dense += [t(rng.uniform(-lim, lim, (lanes, dims[i], dims[i + 1]))),
                      t(rng.normal(0, 0.05, (lanes, dims[i + 1])))]
        dense.append(t(rng.normal(0, 0.2, (lanes, dims[-1], 1))))
        seeds = torch.from_numpy(rng.integers(0, 2**32, (lanes, len(dims) - 1),
                                              dtype=np.int64)).to(dev)
        return (t(rng.normal(0, 0.1, (lanes, batch, dims[0]))),
                t(rng.integers(0, 2, (lanes, batch))), t(np.ones((lanes, batch))),
                seeds, tuple(dense))

    one, many = operands(1), operands(30)
    try:
        for name, switches in ABLATIONS.items():
            _cuda.build_variant(switches)
            k1._bind.cache_clear()
            for lanes, args in ((1, one), (30, many)):
                us = _kernel_us(lambda: k1._launch_k1(*args, dims, rate))
                print(f"K1 {name:26s} {lanes:2d} lane(s): slab kernel {us['slab']:7.1f} us, "
                      f"weight-gradient kernel {us['dw']:6.1f} us; {card}")
    finally:
        _cuda.build_variant(())
        k1._bind.cache_clear()
    with tempfile.TemporaryDirectory() as tmp:
        # the weight tiles' way from L2, alone
        probe = os.path.join(tmp, "probe_tile_stream")
        subprocess.run([_cuda._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                        "-o", probe, os.path.join(_cuda.CSRC, "probe_tile_stream.cu")],
                       check=True)
        out = subprocess.run([probe], check=True, capture_output=True, text=True).stdout
        for line in out.splitlines():
            print(f"{line}; {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
