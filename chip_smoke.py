#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (mamdr_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

From the repository root, on a machine with a CUDA card, nvcc and PyTorch
built for CUDA. It imports nothing of JAX or of the JAX package. Phases:

  1. the card's name and power limit (nvidia-smi);
  2. build the kernels from mamdr_tpu_torch/csrc/ (build seconds, and
     nvcc -Xptxas -v register / shared-memory use per kernel);
  3. kernel K1 (fused MLP tower step) against its plain PyTorch version at
     the main path's shapes — dropout 0.5, dropout 0, a partial batch, an
     all-pad batch — and its time beside the plain version's;
  4. kernel K2 (row gather) against its plain version on a [100000, 128]
     table with out-of-range ids, and its time beside the plain version's
     and torch.nn.functional.embedding's (a yardstick the port never calls);
  5. the slice: Trainer + MAMDRStrategy at bench.py's shapes (30 domains,
     100k users and items, frozen 128-d tables, MLP 384-256-128-64-1,
     dropout 0.5, batch 1024, flat Adam): one train step through the kernels
     against the same step through the plain versions, then one full
     Domain-Negotiation phase (360 steps) with its launch counts, losses,
     the update of `shared`, and its time;
  6. one JSON line describing each kernel;
  7. the last line: {"ok": true, "device": {...}}.

Any failure raises and the script exits non-zero. Without a card it exits
non-zero before printing any result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet, at the full 700 W limit)
FP32_FLOPS = 67e12   # float32 outside the tensor cores
HBM_BYTES = 3.35e12  # bytes/s
K1_REL_TOL = 1e-4    # of each output's largest magnitude (float32 sums over
                     # up to 1024 rows, taken in another order)


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def device_ms(fn, inner: int = 20, reps: int = 5) -> float:
    """Device milliseconds per call of fn: `inner` calls captured in a CUDA
    graph, replayed `reps` times between CUDA events (no host overhead)."""
    import torch

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


def eager_ms(fn, iters: int = 50) -> float:
    """Milliseconds per call issued one by one from the host (what the train
    loop sees), between CUDA events after a warm-up."""
    import torch

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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mamdr_tpu_torch.ops import _cuda
    from mamdr_tpu_torch.ops.embedding_lookup import (
        embedding_lookup,
        embedding_lookup_reference,
    )
    from mamdr_tpu_torch.ops.fused_mlp_step import (
        fused_tower_grad,
        make_fast_loss_grad,
        tower_grad_reference,
    )
    from mamdr_tpu_torch.train.steps import make_train_step
    from mamdr_tpu_torch.utils import trees
    from mamdr_tpu_torch.workload import build_bench_strategy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. the card ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    card = f"{torch.cuda.get_device_name(0)}, power limit {smi.split(',')[-1].strip()}"
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    # ---- 2. build ----
    t0 = time.perf_counter()
    _cuda.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(_cuda.SOURCES)} sources "
          f"(parallel nvcc; per source {json.dumps({k: round(v, 1) for k, v in _cuda.build_seconds.items()})})")
    for name in _cuda.SOURCES:
        fn_name = None
        for line in _cuda.build_log.get(name, "").splitlines():
            if "Compiling entry function" in line:
                fn_name = line.split("'")[1] if "'" in line else line
            elif "Used" in line and "registers" in line:
                print(f"ptxas {name}.cu {fn_name}: {line.split(':', 1)[1].strip()}")

    # ---- 3. K1 vs its plain version at main-path shapes ----
    dims = (384, 256, 128, 64)
    batch = 1024
    rng = np.random.default_rng(0)

    def tower_inputs(case):
        x = torch.from_numpy(rng.normal(0, 0.1, (batch, dims[0])).astype(np.float32)).to(dev)
        label = torch.from_numpy(rng.integers(0, 2, batch).astype(np.float32)).to(dev)
        w = np.ones(batch, np.float32)
        if case == "partial":
            w[736:] = 0.0  # a domain's last batch: 12000 = 11*1024 + 736
        elif case == "all_pad":
            w[:] = 0.0
        weight = torch.from_numpy(w).to(dev)
        dense = []
        for i in range(len(dims) - 1):
            lim = np.sqrt(6.0 / (dims[i] + dims[i + 1]))
            dense.append(rng.uniform(-lim, lim, (dims[i], dims[i + 1])).astype(np.float32))
            dense.append(rng.normal(0, 0.05, dims[i + 1]).astype(np.float32))
        dense.append(rng.normal(0, 0.2, (dims[-1], 1)).astype(np.float32))
        dense = tuple(torch.from_numpy(a).to(dev) for a in dense)
        seeds = torch.tensor([0xDEADBEEF, 12345, 2**31 + 7], dtype=torch.int64, device=dev)
        return x, label, weight, seeds, dense

    k1_err = 0.0
    for case, rate in (("mixed", 0.5), ("mixed", 0.0), ("partial", 0.5), ("all_pad", 0.5)):
        args = tower_inputs(case)
        lk, dxk, gk = fused_tower_grad(*args, dims, rate)
        lp, dxp, gp = tower_grad_reference(*args, dims, rate)
        torch.cuda.synchronize()
        worst = 0.0
        for a, b in [(lk, lp), (dxk, dxp), *zip(gk, gp)]:
            err = float((a - b).abs().max())
            scale = float(b.abs().max())
            if not np.isfinite(err) or err > K1_REL_TOL * max(scale, 1e-30):
                fail(f"K1 {case} rate {rate}: max abs err {err} vs scale {scale}")
            worst = max(worst, err)
        k1_err = max(k1_err, worst)
        print(f"K1 fused_tower_grad vs plain [{case}, rate {rate}]: loss {float(lk):.6f} "
              f"vs {float(lp):.6f}, max abs err {worst:.3e} (tol {K1_REL_TOL} of each "
              f"output's max)")
    args = tower_inputs("mixed")
    k1_ms = device_ms(lambda: fused_tower_grad(*args, dims, 0.5))
    k1_plain_ms = device_ms(lambda: tower_grad_reference(*args, dims, 0.5))
    k1_eager_ms = eager_ms(lambda: fused_tower_grad(*args, dims, 0.5))
    sum_mn = sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))
    n_par = sum_mn + sum(dims[1:]) + dims[-1]
    k1_flops = 6 * batch * sum_mn + 4 * batch * dims[-1]
    k1_bytes = 4 * (2 * batch * dims[0] + 2 * batch + len(dims) - 1 + 2 * n_par + 1)
    k1_bound = max(k1_flops / FP32_FLOPS, k1_bytes / HBM_BYTES) * 1e3
    print(f"K1 time: {k1_ms * 1e3:.1f} us/call on the device (CUDA graph), "
          f"{k1_eager_ms * 1e3:.1f} us/call issued eagerly; plain {k1_plain_ms * 1e3:.1f} us; "
          f"bound {k1_bound * 1e3:.2f} us ({k1_flops / 1e9:.3f} GFLOP, "
          f"{k1_bytes / 1e6:.2f} MB); {card}")

    # ---- 4. K2 vs its plain version ----
    n_rows, dim = 100_000, 128
    table = torch.from_numpy(rng.normal(0, 0.1, (n_rows, dim)).astype(np.float32)).to(dev)
    ids_np = rng.integers(0, n_rows, batch).astype(np.int32)
    ids_np[:6] = [-1, -(2**31), n_rows, n_rows + 5, 2**31 - 1, n_rows - 1]
    ids = torch.from_numpy(ids_np).to(dev)
    got = embedding_lookup(table, ids)
    want = embedding_lookup_reference(table, ids)
    torch.cuda.synchronize()
    k2_err = float((got - want).abs().max())
    # the domain table's shape on the main path: [30, 128], one id per batch
    dom_table = torch.from_numpy(rng.normal(0, 1e-4, (30, dim)).astype(np.float32)).to(dev)
    dom_ids = torch.full((batch,), 7, dtype=torch.int32, device=dev)
    dom_err = float((embedding_lookup(dom_table, dom_ids)
                     - embedding_lookup_reference(dom_table, dom_ids)).abs().max())
    if k2_err != 0.0 or dom_err != 0.0:
        fail(f"K2 differs from the plain gather: max abs err {k2_err}, {dom_err}")
    print(f"K2 gather_rows vs plain [{n_rows}x{dim} table, {batch} ids, 6 out of range "
          f"or at the edge; and a 30x{dim} domain table]: max abs err {k2_err}, "
          f"{dom_err} (tol 0: a gather is exact)")
    ids_long = ids.long().clamp(0, n_rows - 1)
    k2_ms = device_ms(lambda: embedding_lookup(table, ids), inner=50)
    k2_plain_ms = device_ms(lambda: embedding_lookup_reference(table, ids), inner=50)
    k2_lib_ms = device_ms(lambda: torch.nn.functional.embedding(ids_long, table), inner=50)
    k2_bytes = 4 * batch + 2 * 4 * batch * dim
    k2_bound = k2_bytes / HBM_BYTES * 1e3
    print(f"K2 time: {k2_ms * 1e3:.2f} us/call; plain {k2_plain_ms * 1e3:.2f} us; "
          f"F.embedding {k2_lib_ms * 1e3:.2f} us; bound {k2_bound * 1e3:.3f} us "
          f"({k2_bytes / 1e6:.3f} MB); {card}")

    # ---- 5. the slice at bench.py's shapes ----
    t0 = time.perf_counter()
    trainer, strat = build_bench_strategy()  # no device given: the card
    ds, n_domain = trainer.dataset, trainer.dataset.n_domain
    torch.cuda.synchronize()
    print(f"slice set-up: {time.perf_counter() - t0:.1f} s (dataset, tables, trainer, "
          f"{n_domain} specific draws, device block)")

    # One train step through the kernels vs the same step through the plain
    # versions, on the first batch of domain 0. Compared: the loss and the
    # optimizer's new moments mu, nu (linear and quadratic in the gradient).
    # The parameters themselves are Adam's normalisation of mu/nu, which
    # turns last-bit differences of near-zero gradients into steps of order
    # lr, so they are not a measure of the kernels.
    batch0 = {k: v[0, :batch].contiguous() for k, v in strat._block.items()}
    step_k = make_train_step(trainer.model, trainer.tx, trainer.step_cfg)
    step_p = make_train_step(
        trainer.model, trainer.tx, trainer.step_cfg,
        loss_grad=make_fast_loss_grad(trainer.model, trainer.step_cfg,
                                      tower_grad=tower_grad_reference,
                                      lookup=embedding_lookup_reference))
    s_k, l_k = step_k(trainer.state, batch0)
    s_p, l_p = step_p(trainer.state, batch0)
    torch.cuda.synchronize()
    step_err = 0.0
    for what, a, b in (("loss", l_k, l_p), ("mu", s_k.opt_state.mu, s_p.opt_state.mu),
                       ("nu", s_k.opt_state.nu, s_p.opt_state.nu)):
        err = float((a - b).abs().max())
        if not np.isfinite(err) or err > K1_REL_TOL * float(b.abs().max()):
            fail(f"train step {what}: kernels and plain versions differ by {err}")
        step_err = max(step_err, err / max(float(b.abs().max()), 1e-30))
    if int(s_k.step) != 1 or not all(bool(torch.isfinite(p).all())
                                     for p in trees.leaves(s_k.params)):
        fail("train step through the kernels did not give one finite step")
    print(f"train step, kernels vs plain versions: loss {float(l_k):.6f} vs {float(l_p):.6f}, "
          f"largest difference in loss, mu, nu {step_err:.2e} of the tensor's max "
          f"(tol {K1_REL_TOL})")

    shared0 = strat.shared
    steps = sum(trainer.steps_per_domain())
    n_examples = sum(s.n for s in ds.train)
    fused_tower_grad.launches = 0
    embedding_lookup.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = strat.run_dn_phase()  # ends in the phase's one host sync
    dn_s = time.perf_counter() - t0
    k1_launches = fused_tower_grad.launches
    k2_launches = embedding_lookup.launches
    if k1_launches != steps or k2_launches != 3 * steps:
        fail(f"DN phase launched K1 {k1_launches}x and K2 {k2_launches}x, "
             f"expected {steps} and {3 * steps}")
    if losses.shape != (n_domain,) or not np.all(np.isfinite(losses)):
        fail(f"DN losses not {n_domain} finite values: {losses}")
    if int(trainer.state.step) != steps:
        fail(f"state.step {int(trainer.state.step)} after {steps} steps")
    moved = [bool(torch.any(a != b)) for (n, a), b in zip(
        trees.leaves_with_names(strat.shared), trees.leaves(shared0))
        if "user_emb" not in n and "item_emb" not in n]
    if not all(moved):
        fail("the reptile update left a trainable leaf of `shared` unchanged")
    print(f"DN phase: {steps} steps over {n_domain} domains, K1 launched {k1_launches}x, "
          f"K2 {k2_launches}x; losses finite (mean {float(np.mean(losses)):.4f}, "
          f"first domain {float(losses[0]):.4f}, last {float(losses[-1]):.4f}); "
          f"shared updated")
    print(f"DN phase time: {dn_s:.3f} s, {n_examples} examples, "
          f"{n_examples / dn_s:.0f} examples/s, {dn_s / steps * 1e3:.3f} ms/step; {card}")

    # ---- 6. kernels ----
    print(json.dumps({"kernels": [
        {"name": "fused_tower_grad", "route": "cuda",
         "source": "mamdr_tpu_torch/csrc/fused_mlp_step.cu",
         "replaces": "mamdr_tpu/ops/fused_mlp_step.py:141",
         "launches": k1_launches, "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": "operations", "library_ms": None},
        {"name": "gather_rows", "route": "cuda",
         "source": "mamdr_tpu_torch/csrc/gather_rows.cu",
         "replaces": "mamdr_tpu/ops/embedding_lookup.py:56",
         "launches": k2_launches, "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
         "bound_by": "bytes", "library_ms": k2_lib_ms},
    ]}))
    # ---- 7. ----
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
