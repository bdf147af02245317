"""Device-time breakdown of kernel K1 and of the DN phase (torch.profiler).

    python3 -m mamdr_tpu_torch.kernel_profile

On one CUDA card, from the repository root. Prints

  1. for kernel K1 (fused_tower_grad) at the main path's shapes (B 1024,
     dims 384-256-128-64, dropout 0.5): the device microseconds per call of
     each CUDA kernel it launches;
  2. for the Domain-Negotiation phase at bench.py's shapes (360 train
     steps): the wall time per step without the profiler, the device busy
     time per step (the sum of kernel times in a profiled run), the idle
     share, and the kernels that take the most device time.

Every line names the card and its power limit.
"""

from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


def _kernel_times(prof):
    """{kernel name: (calls, device us)} from a profile."""
    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        out[e.key] = (e.count, float(us))
    return out


def _short(name: str, width: int = 70) -> str:
    return name if len(name) <= width else name[: width - 3] + "..."


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_profile: no CUDA card available", file=sys.stderr)
        return 1
    from mamdr_tpu_torch.ops.fused_mlp_step import fused_tower_grad
    from mamdr_tpu_torch.workload import build_bench_strategy

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda")

    # ---- 1. one K1 call ----
    dims, batch, rate = (384, 256, 128, 64), 1024, 0.5
    rng = np.random.default_rng(0)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    x = t(rng.normal(0, 0.1, (batch, dims[0])))
    label = t(rng.integers(0, 2, batch))
    weight = t(np.ones(batch))
    dense = []
    for i in range(len(dims) - 1):
        dense += [t(rng.uniform(-0.1, 0.1, (dims[i], dims[i + 1]))),
                  t(rng.normal(0, 0.05, dims[i + 1]))]
    dense.append(t(rng.normal(0, 0.2, (dims[-1], 1))))
    seeds = torch.tensor([1, 2, 3], dtype=torch.int64, device=dev)
    for _ in range(5):
        fused_tower_grad(x, label, weight, seeds, tuple(dense), dims, rate)
    torch.cuda.synchronize()
    calls = 20
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fused_tower_grad(x, label, weight, seeds, tuple(dense), dims, rate)
        torch.cuda.synchronize()
    kt = _kernel_times(prof)
    total = sum(us for _, us in kt.values()) / calls
    print(f"K1 per call: {total:.1f} us of device time in {len(kt)} kernels ({smi})")
    for name, (n, us) in sorted(kt.items(), key=lambda kv: -kv[1][1]):
        print(f"  {us / calls:8.2f} us  {n / calls:4.1f}x/call  {_short(name)}")

    # ---- 2. the DN phase ----
    trainer, strat = build_bench_strategy()
    steps = sum(trainer.steps_per_domain())
    strat.run_dn_phase()  # warm-up: allocator, libraries
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    strat.run_dn_phase()
    wall = (time.perf_counter() - t0) / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        strat.run_dn_phase()
        torch.cuda.synchronize()
    kt = _kernel_times(prof)
    busy = sum(us for _, us in kt.values()) / steps
    print(f"DN step: {wall * 1e6:.1f} us wall without the profiler, {busy:.1f} us device "
          f"busy, idle share {1 - busy / (wall * 1e6):.2f}; {steps} steps ({smi})")
    for name, (n, us) in sorted(kt.items(), key=lambda kv: -kv[1][1])[:15]:
        print(f"  {us / steps:8.2f} us/step  {n / steps:5.1f}x/step  {_short(name)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
