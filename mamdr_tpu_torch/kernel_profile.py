"""Device-time breakdown of kernel K1, the DN and DR phases, the merged eval
and the finetune (torch.profiler).

    python3 -m mamdr_tpu_torch.kernel_profile

On one CUDA card, from the repository root. Prints

  1. for kernel K1 (fused_tower_grad) at the main path's shapes (B 1024,
     dims 384-256-128-64, dropout 0.5): the device microseconds per call of
     each CUDA kernel it launches (the row-slab kernel and the weight-gradient
     kernel, and PyTorch's few elementwise kernels for the seeds);
  2. for the Domain-Negotiation phase at bench.py's shapes (360 train
     steps): the wall time per step without the profiler, the device busy
     time per step (the sum of kernel times in a profiled run), the idle
     share, CUDA launches per step, and the kernels that take the most
     device time;
  3. for the Domain-Regularization phase of the same epoch, run as 30
     query-domain lanes (144 lane-steps): the same per lane-step — wall
     time, device busy time, idle share, CUDA launches per lane-step, the
     kernels that take the most device time — and K1 over 30 lanes alone;
  4. the same DR phase run sequentially (``dr_parallel`` "off": 4320
     single-lane steps), wall time only, beside the lanes';
  5. after the epoch: one call of the merged eval over the val split (every
     domain a lane, 4 lane-steps, its stack, merge and one host read
     included) and one finetune epoch of SGD lanes (12 lane-steps): per
     lane-step the wall time, device busy time, idle share, CUDA launches
     and the kernels that take the most device time (printed before part 4,
     which builds a strategy of its own);
  6. the meta-gradient accumulate step that MAML, MLDG and PCGrad run
     (``fused._grad_epoch_on_flat`` over one domain's 12 batches: K2, K1 at
     dropout rate 0, the gradient tree and the accumulator's adds, no
     optimizer), and the uncertainty-weighted train step (autograd through
     the model, K2 in its forward, flat Adam): per step the wall time,
     device busy time, idle share, CUDA launches and the kernels that take
     the most device time (printed after part 5);
  7. the zoo without the fused tower kernel: for DeepFM, AutoInt and PLE at
     bench shapes (the corpus's Taobao_30 model blocks, dropout 0.5), one
     joint autograd train step (K2 in the forward, its autograd rule's
     scatter-add, flat Adam; domain 0's 12 steps) and one DR autograd
     lane-step (30 query-domain lanes through ``apply_lanes``, every
     trainable leaf lane-stacked; 12 lane-steps): per step the wall time,
     device busy time, idle share, CUDA launches and the kernels and host
     ops that take the most time (printed after part 6);
  8. STAR (``star_meta_mamdr_finetune`` at bench shapes: PartitionedNorm,
     StarFCN [256, 128, 64], the batch statistics in the state): one joint
     autograd train step (domain 0's 12 steps), one step of the sequential
     DR phase (one query domain's 6 support runs of 12 support and 12 query
     steps, 144 steps; DR cannot take the lanes with batch statistics), and
     one finetune lane-step (30 domain lanes of SGD, the statistics
     lane-stacked; 12 lane-steps): per step the wall time, device busy
     time, idle share, CUDA launches and the kernels and host ops that take
     the most time (printed after part 7);
  9. the per-call route (``Trainer.fit_domain`` / ``evaluate_domain``, the
     loops' path): one ``fit_domain`` epoch of domain 0 (12 steps: the
     np_rng order uploaded, the batches gathered on the device, K2, K1,
     flat Adam), one MAML ``accumulate_split`` of domain 0's train split in
     the "drop" mode (12 accumulate steps: K2, K1 at rate 0, the hash
     masks) and one ``evaluate_domain`` of domain 0's val split (4 eval
     steps, K2 with ids [B], the AUC, one host read): per step the wall
     time, device busy time, idle share, CUDA launches and the kernels and
     host ops that take the most time (printed after part 8).

Every line names the card and its power limit. Its per-step numbers are read
from outside the program (a profile around each phase or step it drives);
the program's own spans and counters are ``utils/trace.py``'s, and a run's
trace is ``train.profile_dir``'s. This script stays for what nothing else
measures: the eval, the finetune, the zoo's and STAR's steps.
"""

from __future__ import annotations

import shutil
import sys
import tempfile
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
    from mamdr_tpu_torch.ops.fused_mlp_step import fused_tower_grad, fused_tower_grad_lanes
    from mamdr_tpu_torch.utils.timing import card_line
    from mamdr_tpu_torch.workload import build_bench_strategy

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = card_line()
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
    ckpt = tempfile.mkdtemp(prefix="mamdr_kernel_profile_")
    trainer, strat = build_bench_strategy(checkpoint_path=ckpt)
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
    launches = sum(n for n, _ in kt.values()) / steps
    print(f"DN step: {wall * 1e6:.1f} us wall without the profiler, {busy:.1f} us device "
          f"busy, idle share {1 - busy / (wall * 1e6):.3f}, {launches:.0f} CUDA launches; "
          f"{steps} steps ({smi})")
    for name, (n, us) in sorted(kt.items(), key=lambda kv: -kv[1][1])[:15]:
        print(f"  {us / steps:8.2f} us/step  {n / steps:5.1f}x/step  {_short(name)}")

    # ---- 3. the DR phase as lanes, on the draws of the last DN phase ----
    if not strat.dr_lanes:
        print("kernel_profile: the DR phase did not take the lanes", file=sys.stderr)
        return 1
    strat.run_dr_phase()  # warm-up
    torch.cuda.synchronize()
    fused_tower_grad_lanes.launches = 0
    t0 = time.perf_counter()
    strat.run_dr_phase()
    torch.cuda.synchronize()
    lane_steps = fused_tower_grad_lanes.launches
    lanes_s = time.perf_counter() - t0
    wall = lanes_s / lane_steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        strat.run_dr_phase()
        torch.cuda.synchronize()
    kt = _kernel_times(prof)
    busy = sum(us for _, us in kt.values()) / lane_steps
    launches = sum(n for n, _ in kt.values()) / lane_steps
    print(f"DR lane-step ({trainer.dataset.n_domain} lanes): {wall * 1e6:.1f} us wall without "
          f"the profiler, {busy:.1f} us device busy, idle share "
          f"{1 - busy / (wall * 1e6):.3f}, {launches:.0f} CUDA launches; "
          f"{lane_steps} lane-steps ({smi})")
    for name, (n, us) in sorted(kt.items(), key=lambda kv: -kv[1][1])[:15]:
        print(f"  {us / lane_steps:8.2f} us/lane-step  {n / lane_steps:5.1f}x/lane-step  "
              f"{_short(name)}")
    k1_kernels = ("slab_kernel", "dw_kernel")  # csrc/fused_mlp_step.cu
    k1 = sum(us for name, (_, us) in kt.items()
             if any(k in name for k in k1_kernels)) / lane_steps
    print(f"K1 over {trainer.dataset.n_domain} lanes: {k1:.1f} us of the lane-step's device "
          f"time ({smi})")

    # ---- 5. a merged-eval lane-step and a finetune lane-step ----
    def breakdown(what, run, steps, top=10, unit="lane-step", host_top=0):
        run()  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        kt = _kernel_times(prof)
        busy = sum(us for _, us in kt.values()) / steps
        launches = sum(n for n, _ in kt.values()) / steps
        print(f"{what}: {wall * 1e6:.1f} us wall without the profiler, {busy:.1f} us device "
              f"busy, idle share {1 - busy / (wall * 1e6):.3f}, {launches:.0f} CUDA launches "
              f"a {unit}; {steps} {unit}s a call ({smi})")
        for name, (n, us) in sorted(kt.items(), key=lambda kv: -kv[1][1])[:top]:
            print(f"  {us / steps:8.2f} us/{unit}  {n / steps:5.1f}x/{unit}  {_short(name)}")
        host = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CPU),
                      key=lambda e: -e.self_cpu_time_total)
        for e in host[:host_top]:  # where the host's time goes (profiled, so inflated)
            print(f"  host {e.self_cpu_time_total / steps:8.2f} us/{unit}  "
                  f"{e.count / steps:5.1f}x/{unit}  {_short(e.key)}")

    from mamdr_tpu_torch.strategies import separate
    from mamdr_tpu_torch.train import fused

    tc = trainer.config.train
    merged_eval = fused.make_fused_eval_merged(trainer.model, trainer.step_cfg, strat.mask,
                                               tc.merged_method)
    vblock = trainer.eval_block("val")

    def eval_call():
        stack = fused.stack_specific(strat.specific, strat.mask)
        losses, aucs = merged_eval(trainer.state.params, strat.shared, stack, vblock)
        return torch.stack([losses, aucs]).cpu()  # the eval's one host read

    breakdown(f"merged eval lane-step ({trainer.dataset.n_domain} lanes)", eval_call,
              vblock["weight"].shape[1])
    lanes = separate.make_lanes(trainer, False, strat._best_params_fn)
    breakdown(f"finetune lane-step ({trainer.dataset.n_domain} SGD lanes)",
              lambda: lanes.epoch_all(lanes.states, lanes.block, trainer.gen),
              lanes.block["weight"].shape[1] // trainer.dataset.batch_size)
    del lanes

    # ---- 6. the accumulate step (K2 + K1 at rate 0, no optimizer) ----
    block, n_steps = trainer.train_block()
    flat0 = {k: v[0] for k, v in block.items()}
    acc0 = fused.zeros_acc(strat.mask, trainer.state.params)
    breakdown("accumulate step (K2, K1 at rate 0, grads into the accumulator)",
              lambda: fused._grad_epoch_on_flat(
                  trainer.accum_grad_fn, trainer.state.params, flat0, trainer.gen, n_steps,
                  trainer.dataset.batch_size, acc0, strat.mask,
                  real_steps=trainer.steps_per_domain()[0]),
              trainer.steps_per_domain()[0], unit="step", host_top=8)
    del acc0
    # ... and uncertainty weighting's train step (autograd; K2 in its forward)
    from mamdr_tpu_torch.workload import build_bench_trainer

    unc = build_bench_trainer("mlp_uncertainty_weight", checkpoint_path=ckpt,
                              dataset=trainer.dataset)
    unc_step = unc.train_step_fn()
    breakdown("uncertainty-weighted train step (autograd, flat Adam)",
              lambda: fused._epoch_on_flat(unc_step, unc.state, flat0, unc.gen, n_steps,
                                           unc.dataset.batch_size,
                                           real_steps=unc.steps_per_domain()[0]),
              unc.steps_per_domain()[0], unit="step", host_top=12)
    del unc, unc_step, flat0

    # ---- 7. the zoo: a joint autograd step and a DR autograd lane-step ----
    from mamdr_tpu_torch.models.embeddings import frozen_mask
    from mamdr_tpu_torch.train.steps import make_subset_train_step
    from mamdr_tpu_torch.utils import trees

    for name in ("deepfm", "autoint", "ple"):
        zt = build_bench_trainer(name, checkpoint_path=ckpt, dataset=trainer.dataset)
        zblock, zn = zt.train_block()
        zflat0 = {k: v[0] for k, v in zblock.items()}
        zstep = zt.train_step_fn()
        breakdown(f"{name} joint train step (autograd, K2, flat Adam)",
                  lambda: fused._epoch_on_flat(zstep, zt.state, zflat0, zt.gen, zn,
                                               zt.dataset.batch_size,
                                               real_steps=zt.steps_per_domain()[0]),
                  zt.steps_per_domain()[0], unit="step", host_top=8)
        frozen = frozen_mask(zt.state.params, emb_trainable=False)  # pretrained tables
        mask = trees.tree_map(lambda x: True, zt.state.params)  # meta_parms "all"
        sub_step, to_sub, _ = make_subset_train_step(zt.model, zt.tx, zt.step_cfg, frozen,
                                                     zt.state.params)
        n_lanes = zt.dataset.n_domain
        lane_state = fused.make_lane_state(zt.state, to_sub(zt.state.params), mask, n_lanes)
        # the DR phase loads each lane's merged weights over the masked
        # leaves' broadcast views first; here every lane gets its own copy
        lane_state = lane_state.replace(params=trees.tree_map(
            lambda x: x.contiguous(), lane_state.params))
        breakdown(f"{name} DR lane-step ({n_lanes} lanes, autograd through apply_lanes)",
                  lambda: fused._epoch_on_flat(sub_step, lane_state, zblock, zt.gen, zn,
                                               zt.dataset.batch_size,
                                               real_steps=max(zt.steps_per_domain())),
                  max(zt.steps_per_domain()), host_top=8)
        del zt, zblock, zflat0, zstep, sub_step, lane_state
        torch.cuda.empty_cache()

    # ---- 8. STAR: a joint step, a sequential-DR step, a finetune lane-step ----
    from mamdr_tpu_torch.strategies.mamdr import MAMDRStrategy

    st = build_bench_trainer("star_meta_mamdr_finetune", checkpoint_path=ckpt,
                             dataset=trainer.dataset)
    sblock, sn = st.train_block()
    sflat0 = {k: v[0] for k, v in sblock.items()}
    sstep = st.train_step_fn()
    breakdown("STAR joint train step (autograd, K2, PartitionedNorm stats, flat Adam)",
              lambda: fused._epoch_on_flat(sstep, st.state, sflat0, st.gen, sn,
                                           st.dataset.batch_size,
                                           real_steps=st.steps_per_domain()[0]),
              st.steps_per_domain()[0], unit="step", host_top=8)
    sstrat = MAMDRStrategy(st)
    sstrat.prepare_fused()
    if sstrat.dr_lanes:
        print("kernel_profile: STAR's DR took the lanes", file=sys.stderr)
        return 1
    sorder, saux = sstrat.draw_epoch()
    one_query = 2 * saux.shape[1] * st.steps_per_domain()[0]
    breakdown(f"STAR sequential DR step (one query domain, {saux.shape[1]} support runs)",
              lambda: sstrat._dr_phase(st.state, sstrat.shared, sstrat._spec_stack, sblock,
                                       sorder[:1], saux[:1], st.gen,
                                       float(sstrat.tc.meta_learning_rate)),
              one_query, unit="step", host_top=8)
    slanes = separate.make_lanes(st, init_params=False, params_fn=sstrat._best_params_fn)
    breakdown(f"STAR finetune lane-step ({len(slanes.ids)} lanes, SGD, stats lane-stacked)",
              lambda: slanes.epoch_all(slanes.states, slanes.block, st.gen),
              st.steps_per_domain()[0], host_top=8)
    del st, sstrat, sblock, sflat0, sstep, slanes
    torch.cuda.empty_cache()

    # ---- 9. the per-call route: fit_domain, accumulate_split, evaluate_domain ----
    from mamdr_tpu_torch.strategies.base import build_strategy

    pt = build_bench_trainer("mlp_meta_maml_finetune", checkpoint_path=ckpt,
                             dataset=trainer.dataset)
    pt.config.train.average_meta_grad = "drop"
    pstrat = build_strategy(pt)
    per_call = pt.steps_per_domain()[0]
    breakdown("per-call train step (fit_domain: the order uploaded, K2, K1, flat Adam)",
              lambda: pt.fit_domain(pt.state, 0), per_call, unit="step", host_top=8)
    split0 = pt.dataset.train[0]
    breakdown('per-call accumulate step (accumulate_split, "drop": K2, K1 at rate 0, hash masks)',
              lambda: pstrat.accumulate_split(pt.state.params, split0,
                                              fused.zeros_acc(pstrat.mask, pt.state.params),
                                              cap=False),
              per_call, unit="step", host_top=8)
    breakdown("per-call eval step (evaluate_domain: K2 with ids [B], the AUC, one read)",
              lambda: pt.evaluate_domain("val", 0, pt.state.params, pt.state.batch_stats),
              pt.eval_steps_per_domain("val")[0], unit="step", host_top=8)
    del pt, pstrat
    torch.cuda.empty_cache()

    # ---- 4. the same DR phase, sequential ----
    del trainer, strat
    trainer, strat = build_bench_strategy(dr_parallel="off", checkpoint_path=ckpt)
    if strat.dr_lanes:
        print("kernel_profile: dr_parallel 'off' still took the lanes", file=sys.stderr)
        return 1
    strat.run_dn_phase()  # the draws, and a warm-up
    fused_tower_grad.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    strat.run_dr_phase()
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    seq_steps = fused_tower_grad.launches
    print(f"DR phase, sequential: {seq_s:.3f} s for {seq_steps} steps "
          f"({seq_s / seq_steps * 1e6:.1f} us/step, one run after a DN phase); as lanes {lanes_s:.3f} s "
          f"for {lane_steps} lane-steps ({smi})")
    shutil.rmtree(ckpt, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
