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
     all-pad batch — then at a batch that is no multiple of its row slab and
     at narrow dims that cut through every tile, the CUDA launches one call
     issues, and its time beside the plain version's; then K1 over
     30 lanes (the DR phase's shape) against the lane-batched plain version
     (independent of the kernel: ReLU units whose pre-activation the two put
     on different sides of 0 are counted and their rows set aside),
     with a partial and an all-pad lane in the same call, each lane bit-equal
     to the single-lane call, and its time;
  4. kernel K2 (the field gather: three tables' rows into the tower input x
     in one launch) exactly against its plain version at the DN step's shape
     (3 fields x 1024 ids, two [100000, 128] tables with out-of-range ids, a
     [30, 128] domain table with one id) and at the DR lane-step's (3 x 30720
     ids over 30 lanes, a lane-stacked [30, 30, 128] domain table, ids out of
     range in every lane), with the row ids it writes; its time at both over
     4 id sets in turn beside the route it replaces (three one-field
     launches and torch.cat), the plain version, and torch.cat of three
     torch.nn.functional.embedding calls (a yardstick the port never calls),
     and its bound from the rows the ids touch; its one-field case timed too;
     kernel K3 (the ring gather) exact against both at k 32 and k 128, at
     1024 ids and at 30720 ids (where a block's ring turns) with ids out of
     range, and at a k larger than a block's rows; its time at both sizes,
     and the gather probe (mamdr_tpu_torch.probe_gather), the one path that
     runs K3, with K3's launches on it at each depth and size;
  5. the slice: Trainer + MAMDRStrategy at bench.py's shapes (30 domains,
     100k users and items, frozen 128-d tables, MLP 384-256-128-64-1,
     dropout 0.5, batch 1024, flat Adam): one train step through the kernels
     against the same step through the plain versions, one full
     Domain-Negotiation phase (360 steps) with its launch counts, losses,
     the update of `shared`, and its time; then the Domain-Regularization
     phase of the same epoch as 30 query-domain lanes (144 lane-steps) with
     its launch counts, the update of every domain's `specific`, and its
     time, and one DR lane-step through the kernels against the same
     lane-step through the plain versions;
  5c. after the epoch, the rest of the flow a user runs, each path with its
     launch counts asserted: the epoch's tail (merged validation of every
     domain as a lane, early stop, best snapshot and its checkpoint files in
     a temporary directory); the validation alone (4 lane-steps through K2,
     examples/s, macro and weighted AUC), held bit for bit to the same eval
     through the plain gather; the test with the best snapshot; the finetune
     stage (30 domains as SGD lanes: 12 lane-steps of K1-lanes and K2 an
     epoch, then val and test), every domain's best weights moved; one
     finetune lane-step through the kernels against the plain versions and
     K1-lanes held to its plain version on its operands; one finetune epoch
     timed alone; the whole run(); and a small run() on the card against the
     same run() on the CPU;
  5d. file-backed data and the other MLP strategies: the bench data written
     in the reference's on-disk layout (30 domains x train/val/test CSV,
     100k x 128 user and item emb JSON, vocab JSON, a domain_property.json)
     and read by MultiDomainDataset.from_disk through the native CSV loader,
     timed and held bit for bit to the in-memory data; the CLI
     (python -m mamdr_tpu_torch.run --config, mlp_meta_mamdr_finetune) in its
     own process on that tree, its result folder checked; run() of mlp,
     mlp_finetune, mlp_separate, mlp_meta_domain_negotiation_finetune and
     mlp_meta_reptile_finetune at bench shapes on the loaded data with their
     launch counts asserted, each timed with its train epoch, weights moved,
     meta moved on masked leaves only; and a small run() of each on the card
     against the same run() on the CPU;
  5e. MAML, MLDG, PCGrad and uncertainty weighting: one meta-gradient
     accumulate step (K2, then K1 at dropout rate 0 under the 0.5-dropout
     model; no optimizer) against the same step through the plain versions,
     and K1 at rate 0 timed; run() of mlp_meta_maml_finetune,
     mlp_meta_mldg_finetune, mlp_pcgrad and mlp_uncertainty_weight at bench
     shapes on the loaded data (the corpus's learning rates, meta split and
     sample_num for each name, epoch 1) with their launch counts asserted,
     each timed with its train epoch, weights moved, meta moved on masked
     leaves only, frozen tables the same tensors, log_vars moved; and a small
     run() of each on the card against the same run() on the CPU;
  5f. the rest of the zoo without batch statistics (WDL, DeepFM, NFM,
     AutoInt, CCPM, PNN, SharedBottom, MMoE, PLE at the corpus's Taobao_30
     model blocks): one autograd lane step of each at 30 lanes x 1024 ids
     (every lane its own weights, the domain table lane-stacked) through K2
     against the same step through K2's plain version; run() of each joint
     name and of deepfm_meta_mamdr_finetune and mmoe_meta_mamdr_finetune at
     bench shapes on the loaded data with their launch counts asserted (K1
     none: every step is autograd, K2 a step and an eval lane-step), each
     timed with its train epoch, weights moved, frozen tables (the linear
     ones too) the same tensors, MAMDR's DR as lanes with every domain's
     specific moved; and a small run() of each on the card against the
     same run() on the CPU;
  5g. STAR with its per-domain batch statistics (PartitionedNorm, StarFCN
     [256, 128, 64], the corpus's Taobao_30 model block): one autograd train
     step (3 fields x 1024 ids, the statistics updated) and one finetune
     lane-step (30 domain lanes of SGD, the statistics lane-stacked) through
     K2 against the same through K2's plain version, the step moving only
     its domain's statistics row; run() of star and star_meta_mamdr_finetune
     at bench shapes on the loaded data with their launch counts asserted
     (K2 only; MAMDR's DR sequential, 4320 steps), each timed with its train
     epoch, weights and statistics moved and finite, frozen tables the same
     tensors; and a small run() of each on the card against the CPU;
  5h. the per-call route (Trainer.stack_train_epoch / fit_domain /
     evaluate_domain) and the loops on it: one per-call train step and one
     per-call accumulate step through the kernels against the same steps
     through the plain versions (1e-4), K1 held to its plain version on
     their operands; run() at bench shapes of mlp_meta_mamdr_finetune under
     fixed_train (the per-call _train_loop, then _separate_loop as the
     finetune), mlp_meta_mamdr_batch_finetune with finetune_every_epoch,
     mlp_meta_domain_negotiation_finetune with target_domain 0 and
     meta_finetune_step 1 (the meta-finetune lanes: K1-lanes),
     mlp_meta_maml_finetune with average_meta_grad "drop" and mlp_pcgrad
     with target_domain 0, each with its launch counts asserted, timed with
     its train epoch and its host-paced steps, weights moved, frozen tables
     the same tensors; and a small run() of each, and of
     star_meta_mamdr_finetune under fixed_train, on the card against the
     CPU; the per-call finetune's domain_{d}.npz hold the whole best tree;
  5i. resume at bench shapes (mlp_meta_mamdr_finetune), deterministic
     algorithms on (the domain table's index_add_ adds in a varying order
     otherwise): run() of 2 epochs unbroken; 1 epoch that writes the resume
     snapshot (its seconds and bytes); a fresh Trainer with resume whose
     run() starts at epoch 1, launches one epoch fewer than the unbroken run
     (K1, K1-lanes, K2 and K2's split asserted) and ends where it ends:
     shared, every specific, the best snapshot, the params and the test
     losses and AUCs bit-equal; then two more unbroken runs with
     deterministic algorithms off, their distance printed (run to run);
  5j. the model learns on the card: the Taobao-10 recipe of the JAX
     package's validation (mamdr_tpu_torch.validate: the generated click log
     and the port's Taobao ETL, timed; from_disk), then run() of
     mlp_meta_mamdr_finetune at most LEARN_EPOCHS epochs, which fails unless
     the test macro AUC reaches LEARN_GATE; K1-lanes and K2 held to their
     plain versions and timed at its 10-lane shapes;
  5k. TensorBoard at bench shapes: run() of mlp_meta_mamdr_finetune with
     tensorboard, histogram_freq 1 and write_grads, its launch counts
     asserted (5c's run and _sample_grads' one K2); the event files read
     back by TensorBoard's EventAccumulator (every val and test scalar equal to
     metrics.jsonl's, a weight and a grad/ histogram a parameter leaf, each
     counting the leaf's elements) and the seconds the TensorBoard work
     adds; the trained parameters through the Keras h5 mapping and back
     (a file where h5py is installed), bit-equal, an eval on them equal;
  5l. the DR lanes in groups with trainable tables (load_pretrain_emb false,
     emb_trainable true, deterministic algorithms on): the DN phase, the DR
     phase in the JAX package's automatic groups of 7, and the same DR phase
     in one group of 30 from the same entry, each with its launch counts,
     seconds, peak memory and lane-state bytes, held to each other (the
     specific stack, the state, the val losses and AUCs); K1-lanes at 7
     lanes and K2 on lane-stacked trainable [7 | 30, 100000, 128] tables
     against their plain versions and timed;
  5m. bf16 towers and flat_optimizer false: with compute_dtype bfloat16 one
     autograd step and one autograd lane-step through K2 against K2's plain
     version, then run() (K1 none, K2 as 5c's run), weights moved and
     finite; run() with flat_optimizer false and with it true under
     deterministic algorithms, equal bit for bit (the Adam state's count,
     mu and nu included), and the state through the per-leaf optax layout
     of the resume snapshot and back, bit-equal;
  5n. the (data, table) mesh of mamdr_tpu_torch/parallel: K2 with row
     windows exactly against its plain version at the DN and DR shapes at
     both table indices, and timed; then ten processes at once on the
     card, each a rank of mamdr_tpu_torch.parallel.dryrun under
     deterministic algorithms: the bench epoch on (1, 1) over NCCL with a
     run(), on (1, 2) and (2, 1) over gloo, a one-device reference, the
     dry run on (1, 2) — (1, 1) and (1, 2) bit-equal to one device, (2, 1)'s
     step within 1e-5 and its DR and validation from the reference's
     post-DN state bit-equal, every rank's launches one device's with every
     K2 launch windowed — and the resume run (check_resume_tb): run() of 2
     epochs with the resume snapshot every epoch and TensorBoard
     (histogram_freq 1, write_grads) on the (1, 2) ranks and on one device,
     and fresh (1, 2) ranks resumed from the first snapshot, bit-equal to
     the unbroken run with one epoch's launches fewer; the (1, 2) run's
     event files (rank 0's alone) equal to one device's; the snapshot's
     seconds and bytes and the TensorBoard work's seconds;
  6. one JSON line describing each kernel;
  7. the last line: {"ok": true, "device": {...}}.

Any failure raises and the script exits non-zero. Without a card it exits
non-zero before printing any result.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet, at the full 700 W limit)
FP32_FLOPS = 67e12   # float32 outside the tensor cores
TF32_FLOPS = 495e12  # dense TF32 on the tensor cores
HBM_BYTES = 3.35e12  # bytes/s
# Kernel K1 and K3 as they were before their redesign for this card (K1 a
# chain of 24 launches of float32 SIMT products, K3 one ring per block of
# 4k rows), timed by this script on an NVIDIA H100 80GB HBM3 at 700 W:
EARLIER_US = {"K1 one lane": 129.2, "K1 30 lanes": 1680.3, "K3 k 32": 12.12, "K3 k 128": 17.33}
K1_REL_TOL = 1e-4    # of each output's largest magnitude (float32 sums over
                     # up to 1024 rows, taken in another order)
LEARN_EPOCHS = 10    # phase 5j's epoch cap on the Taobao-10 recipe
LEARN_GATE = 0.75    # its least test macro AUC


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def check_resume_tb(work: str) -> list:
    """5n (c): the resume run of ``dryrun.bench_resume`` in ``work``, from the
    one-device reference ("ref"), the unbroken (1, 2) ranks ("1x2") and the
    fresh (1, 2) ranks resumed from their first snapshot ("1x2c"). Fails
    unless every run's launches are the ones its step counts give (K1, K1-
    lanes, K2, K2 with ids [L, B], K2 windowed: every K2 launch of a mesh
    rank windowed, one one-tower K2 a validation's ``_sample_grads``), the
    resumed run starts at epoch 1 and launches one epoch fewer than the
    unbroken one, is bit-equal to it (weights, Adam's slots, the best
    params, the test results), the unbroken (1, 2) run is bit-equal to one
    device's (test losses within 1e-6 relative: the frozen tables' l2 term
    sums its shards in another order), and the (1, 2) run's TensorBoard
    folder holds rank 0's one event file, whose scalars equal one device's
    (losses within 1e-6 relative) and whose weight and gradient histograms
    equal one device's of the same padded tree (buckets, counts, num, min
    and max exactly; sum and sum of squares within 1e-12 relative: float64
    sums over the shards). Returns the lines to print."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    def ranks(tag, n):
        out = []
        for r in range(n):
            with open(os.path.join(work, f"{tag}_resume.npz.rank{r}.json")) as f:
                out.append(json.load(f))
        return out

    def arrays(tag):
        with np.load(os.path.join(work, f"{tag}_resume.npz")) as z:
            return {k: z[k] for k in z.files}

    (ref,), unbroken, resumed = ranks("ref", 1), ranks("1x2", 2), ranks("1x2c", 2)
    st = ref["steps"]
    spd, k, cap, val, test, ft_e = (st["per_domain"], st["k"], st["cap"], st["val"],
                                    st["test"], st["epochs"])
    ft = max(spd)
    dr = k * (ft + (min(ft, cap) if cap > 0 else ft))

    def want(epochs, mesh):
        one_tower = epochs * sum(spd) + epochs  # + a _sample_grads K2 each val epoch
        lane = epochs * (dr + val) + test + (ft + val) * ft_e + test
        return [epochs * sum(spd), epochs * dr + ft * ft_e, one_tower + lane, lane,
                one_tower + lane if mesh else 0]

    one_epoch = [a - c for a, c in zip(want(2, True), want(1, True))]
    for what, runs, epochs, mesh in (("the one-device run", [ref], 2, False),
                                     ("the unbroken (1, 2) run", unbroken, 2, True),
                                     ("the resumed (1, 2) run", resumed, 1, True)):
        for r, j in enumerate(runs):
            if j["steps"] != st or j["run_counts"] != want(epochs, mesh):
                fail(f"5n: {what}, rank {r}, launched (K1, K1-lanes, K2, K2 ids [L, B], K2 "
                     f"windowed) {j['run_counts']}, expected {want(epochs, mesh)}")
    if [j.get("started") for j in resumed] != [1, 1] or unbroken[0].get("started") is not None:
        fail(f"5n: the resumed ranks started at {[j.get('started') for j in resumed]}, "
             "expected epoch 1")
    a, c, one = arrays("1x2"), arrays("1x2c"), arrays("ref")
    if not (sorted(a) == sorted(c) == sorted(one)):
        fail(f"5n: the resume runs' arrays differ in keys: {sorted(a)} / {sorted(c)}")
    diff = [key for key in a if not np.array_equal(a[key], c[key])]
    if diff:
        fail(f"5n: the resumed (1, 2) run is not the unbroken one bit for bit: {diff[:8]}")
    diff = [key for key in a if key != "run_loss" and not np.array_equal(a[key], one[key])]
    test_loss = float(np.max(np.abs(a["run_loss"] - one["run_loss"]) / np.abs(one["run_loss"])))
    if diff or test_loss > 1e-6:
        fail(f"5n: the unbroken (1, 2) run is not one device's: {diff[:8]}, test losses "
             f"{test_loss} apart (tol 1e-6 relative)")

    logdir = unbroken[0]["logdir"]
    if unbroken[1]["logdir"] != logdir or len(os.listdir(logdir)) != 1:
        fail(f"5n: the (1, 2) run's TensorBoard folder holds {os.listdir(logdir)}, expected "
             "rank 0's one event file")
    acc = {}
    for tag, d in (("mesh", logdir), ("one", ref["logdir"])):
        acc[tag] = EventAccumulator(d, size_guidance={"scalars": 0, "histograms": 0})
        acc[tag].Reload()
    tags = {kind: sorted(acc["one"].Tags()[kind]) for kind in ("scalars", "histograms")}
    if any(sorted(acc["mesh"].Tags()[kind]) != tags[kind] for kind in tags):
        fail(f"5n: the (1, 2) run's TensorBoard tags differ from one device's: "
             f"{acc['mesh'].Tags()}")
    scalar_d = 0.0
    for tag in tags["scalars"]:
        m, o = acc["mesh"].Scalars(tag), acc["one"].Scalars(tag)
        if [e.step for e in m] != [e.step for e in o]:
            fail(f"5n: TensorBoard {tag}: steps {[e.step for e in m]} against one device's")
        for x, y in zip(m, o):
            d = abs(x.value - y.value) / max(abs(y.value), 1e-30)
            if (d > 1e-6) if tag.endswith("avg_loss") else x.value != y.value:
                fail(f"5n: TensorBoard {tag} at step {x.step}: {x.value} against one "
                     f"device's {y.value}")
            scalar_d = max(scalar_d, d)
    n_hist = 0
    for tag in tags["histograms"]:
        m, o = acc["mesh"].Histograms(tag), acc["one"].Histograms(tag)
        if [h.step for h in m] != [h.step for h in o] or not m:
            fail(f"5n: TensorBoard histogram {tag}: steps {[h.step for h in m]} against one "
                 f"device's {[h.step for h in o]}")
        for x, y in zip(m, o):
            hx, hy = x.histogram_value, y.histogram_value
            same = (list(hx.bucket_limit) == list(hy.bucket_limit)
                    and list(hx.bucket) == list(hy.bucket)
                    and (hx.num, hx.min, hx.max) == (hy.num, hy.min, hy.max))
            sums = all(abs(p - q) <= 1e-12 * max(abs(q), 1e-300)
                       for p, q in ((hx.sum, hy.sum), (hx.sum_squares, hy.sum_squares)))
            if not (same and sums):
                fail(f"5n: TensorBoard histogram {tag} at step {x.step} differs from one "
                     f"device's: num {hx.num} / {hy.num}, min {hx.min} / {hy.min}, max "
                     f"{hx.max} / {hy.max}, sum {hx.sum} / {hy.sum}")
            n_hist += 1
    snap = unbroken[0]
    snap_bytes = sum(snap["snapshot_bytes"].values())
    return [
        f"5n resume on (1, 2) (mlp_meta_mamdr_finetune at bench shapes, run() of 2 epochs, "
        f"deterministic algorithms): unbroken run() {snap['run_s']:.1f} s, launches per rank "
        f"{snap['run_counts']}; its snapshots {', '.join('%.3f' % x for x in snap['snapshot_s'])}"
        f" s each ({snap_bytes} bytes: {json.dumps(snap['snapshot_bytes'])}); fresh ranks "
        f"resumed from the first at epoch {resumed[0]['started']} (try_resume "
        f"{resumed[0]['resume_s']:.3f} s), run() {resumed[0]['run_s']:.1f} s, launches "
        f"{resumed[0]['run_counts']} (one epoch {one_epoch} fewer), bit-equal to the unbroken "
        f"run ({len(a)} arrays); the unbroken run bit-equal to one device's (test losses "
        f"within {test_loss:.1e}); one device: snapshots "
        f"{', '.join('%.3f' % x for x in ref['snapshot_s'])} s, run() {ref['run_s']:.1f} s",
        f"5n TensorBoard on (1, 2) (histogram_freq 1, write_grads): {snap['tb_s']:.3f} s in "
        f"{snap['tb_calls']} calls on rank 0 ({unbroken[1]['tb_s']:.3f} s on rank 1; one "
        f"device {ref['tb_s']:.3f} s); rank 0's one event file, {len(tags['scalars'])} scalar "
        f"tags equal to one device's (losses within {scalar_d:.1e}), {n_hist} histograms "
        f"({len(tags['histograms'])} tags) equal to one device's of the same padded tree",
    ]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mamdr_tpu_torch.ops import _cuda
    from mamdr_tpu_torch import probe_gather
    from mamdr_tpu_torch.ops.embedding_lookup import (
        CLAMP,
        SILENT,
        WINDOW,
        embedding_lookup,
        embedding_lookup_reference,
        gather_fields,
        gather_fields_reference,
        gather_rows_pipelined,
        ring_plan,
        table_rows,
    )
    from mamdr_tpu_torch.ops.fused_mlp_step import (
        fused_tower_grad,
        fused_tower_grad_lanes,
        k1_cuda_launches,
        k1_launch_plan,
        make_fast_loss_grad,
        tower_grad_reference,
        tower_grad_reference_lanes,
    )
    from mamdr_tpu_torch.config import ExperimentConfig
    from mamdr_tpu_torch.data.synthetic import make_synthetic_dataset
    from mamdr_tpu_torch.strategies import ops as weight_ops
    from mamdr_tpu_torch.strategies import separate
    from mamdr_tpu_torch.strategies.mamdr import MAMDRStrategy
    from mamdr_tpu_torch.train.trainer import Trainer
    from mamdr_tpu_torch.train import fused
    from mamdr_tpu_torch.train.steps import make_subset_train_step, make_train_step
    from mamdr_tpu_torch.utils import trees
    from mamdr_tpu_torch.utils.kernel_check import k1_flip_rows, k1_vs_plain, worst_errors
    from mamdr_tpu_torch.utils.timing import card_line, device_ms, eager_ms
    from mamdr_tpu_torch.workload import build_bench_strategy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. the card ----
    smi = card_line()
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

    def tower_inputs(case, dims=dims, batch=batch):
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
        seeds = torch.tensor([0xDEADBEEF, 12345, 2**31 + 7][: len(dims) - 1],
                             dtype=torch.int64, device=dev)
        return x, label, weight, seeds, dense

    # The plain version is independent of the kernel. Where the two take a
    # ReLU unit differently (a pre-activation within rounding of 0, summed in
    # another order), the units are counted, each must lie at 0 within
    # rounding, and the comparison is made again with those rows' weights 0.
    def report(r):
        return (f"max abs err {r['err']:.3e} (tol {K1_REL_TOL} of each output's max); "
                f"{r['flips']} ReLU units on the edge in {r['rows']} rows set aside, "
                f"largest error with none set aside {r['as_given']:.2e} of the output's max")

    k1_err, k1_flips = 0.0, 0
    for case, rate in (("mixed", 0.5), ("mixed", 0.0), ("partial", 0.5), ("all_pad", 0.5)):
        r = k1_vs_plain(fused_tower_grad, tower_grad_reference, *tower_inputs(case),
                        dims, rate, K1_REL_TOL)
        k1_err, k1_flips = max(k1_err, r["err"]), k1_flips + r["flips"]
        print(f"K1 fused_tower_grad vs plain [{case}, rate {rate}]: loss "
              f"{float(r['out'][0]):.6f}, {report(r)}")
    # a batch that is no multiple of the row slab (its last slab ragged), and
    # narrow dims whose edges cut through every tile of both launches
    for d, b in ((dims, 1000), ((24, 32, 16), 32)):
        for rate in (0.5, 0.0):
            r = k1_vs_plain(fused_tower_grad, tower_grad_reference,
                            *tower_inputs("mixed", d, b), d, rate, K1_REL_TOL)
            k1_err, k1_flips = max(k1_err, r["err"]), k1_flips + r["flips"]
            print(f"K1 fused_tower_grad vs plain [dims {'-'.join(map(str, d))}, B {b}, rate "
                  f"{rate}; slabs of {k1_launch_plan(d, b, 1).slab_rows} rows]: {report(r)}")
    args = tower_inputs("mixed")
    before = k1_cuda_launches()
    fused_tower_grad(*args, dims, 0.5)
    k1_cuda = k1_cuda_launches() - before
    if not 1 <= k1_cuda <= 4 or k1_cuda != k1_launch_plan(dims, batch, 1).launches:
        fail(f"one K1 call issued {k1_cuda} CUDA launches")
    k1_ms = device_ms(lambda: fused_tower_grad(*args, dims, 0.5))
    k1_plain_ms = device_ms(lambda: tower_grad_reference(*args, dims, 0.5))
    k1_eager_ms = eager_ms(lambda: fused_tower_grad(*args, dims, 0.5))
    sum_mn = sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))
    n_par = sum_mn + sum(dims[1:]) + dims[-1]
    k1_flops = 6 * batch * sum_mn + 4 * batch * dims[-1]
    k1_bytes = 4 * (2 * batch * dims[0] + 2 * batch + len(dims) - 1 + 2 * n_par + 1)
    # K1's products run on the tensor cores as three TF32 products each
    k1_bound = max(3 * k1_flops / TF32_FLOPS, k1_bytes / HBM_BYTES) * 1e3
    k1_simt_bound = k1_flops / FP32_FLOPS * 1e3
    print(f"K1 time: {k1_ms * 1e3:.1f} us/call on the device (CUDA graph) in {k1_cuda} CUDA "
          f"launches, {k1_eager_ms * 1e3:.1f} us/call issued eagerly; plain "
          f"{k1_plain_ms * 1e3:.1f} us; bound {k1_bound * 1e3:.2f} us ({k1_flops / 1e9:.3f} "
          f"GFLOP as 3 TF32 products at {TF32_FLOPS / 1e12:.0f} TFLOP/s; {k1_bytes / 1e6:.2f} "
          f"MB; {k1_simt_bound * 1e3:.2f} us at the float32 rate outside the tensor cores); "
          f"{card}")
    print(f"K1 one lane, before and after its redesign: {EARLIER_US['K1 one lane']:.1f} us "
          f"(recorded, 24 launches) -> {k1_ms * 1e3:.1f} us ({k1_cuda} launches); {card}")

    # ---- 3b. K1 over 30 lanes (the DR phase's shape) ----
    lanes = 30

    def lane_inputs():
        per = [tower_inputs({1: "partial", 2: "all_pad"}.get(l, "mixed"))
               for l in range(lanes)]
        x, label, weight = (torch.stack([p[i] for p in per]) for i in range(3))
        dense = tuple(torch.stack([p[4][i] for p in per]) for i in range(len(per[0][4])))
        seeds = torch.from_numpy(rng.integers(0, 2**32, (lanes, len(dims) - 1),
                                              dtype=np.int64)).to(dev)
        return x, label, weight, seeds, dense

    k1l_err, k1l_flips = 0.0, 0
    for rate in (0.5, 0.0):
        args = lane_inputs()
        r = k1_vs_plain(fused_tower_grad_lanes, tower_grad_reference_lanes, *args,
                        dims, rate, K1_REL_TOL)
        lk, dxk, gk = r["out"]
        if float(lk[2]) != 0.0 or bool(dxk[2].any()) or any(bool(g[2].any()) for g in gk):
            fail("K1 lanes: the all-pad lane's loss and gradients are not zero")
        x, label, weight, seeds, dense = args
        for l in range(lanes):  # lane l of the batched call == the single-lane call
            l1, dx1, g1 = fused_tower_grad(x[l], label[l], weight[l], seeds[l],
                                           tuple(t[l] for t in dense), dims, rate)
            same = [torch.equal(l1, lk[l]), torch.equal(dx1, dxk[l]),
                    *(torch.equal(a, b[l]) for a, b in zip(g1, gk))]
            if not all(same):
                fail(f"K1 lanes rate {rate}: lane {l} is not bit-equal to the single-lane call")
        k1l_err, k1l_flips = max(k1l_err, r["err"]), k1l_flips + r["flips"]
        print(f"K1 fused_tower_grad_lanes vs plain [L {lanes}, lane 1 partial, lane 2 all-pad, "
              f"rate {rate}]: {report(r)}; every lane bit-equal to the single-lane call")
    args = lane_inputs()
    k1l_ms = device_ms(lambda: fused_tower_grad_lanes(*args, dims, 0.5), inner=5)
    k1l_plain_ms = device_ms(lambda: tower_grad_reference_lanes(*args, dims, 0.5), inner=2)
    k1l_eager_ms = eager_ms(lambda: fused_tower_grad_lanes(*args, dims, 0.5), iters=20)
    before = k1_cuda_launches()
    fused_tower_grad_lanes(*args, dims, 0.5)
    k1l_cuda = k1_cuda_launches() - before
    if not 1 <= k1l_cuda <= 4:
        fail(f"one K1-lanes call issued {k1l_cuda} CUDA launches")
    k1l_bound = lanes * k1_bound
    print(f"K1 lanes time: {k1l_ms * 1e3:.1f} us/call on the device (CUDA graph) in "
          f"{k1l_cuda} CUDA launches, {k1l_eager_ms * 1e3:.1f} us/call launched eagerly "
          f"({k1l_ms / lanes * 1e3:.1f} us a lane; single-lane K1 {k1_ms * 1e3:.1f} us); "
          f"plain {k1l_plain_ms * 1e3:.1f} us; bound {k1l_bound * 1e3:.1f} us "
          f"({lanes * k1_flops / 1e9:.2f} GFLOP as 3 TF32 products, "
          f"{lanes * k1_bytes / 1e6:.1f} MB; {lanes * k1_simt_bound * 1e3:.1f} us at the "
          f"float32 rate); {card}")
    print(f"K1 {lanes} lanes, before and after its redesign: "
          f"{EARLIER_US['K1 30 lanes']:.1f} us (recorded) -> {k1l_ms * 1e3:.1f} us; {card}")
    del args, lk, dxk, gk, r

    # ---- 4. K2, the field gather, vs its plain version ----
    # The DN step's shapes: user and item tables [100000, 128], the domain
    # table [30, 128], 1024 ids of each, every domain id one and the same (a
    # batch is one domain's); uid and pid with ids out of range or at the edge.
    n_rows, dim, n_dom = 100_000, 128, 30
    mask = (False, False, True)  # what the train step marks: the domain table trains

    def rand_table(shape, scale=0.1):
        return torch.from_numpy(rng.normal(0, scale, shape).astype(np.float32)).to(dev)

    def rand_ids(n, shape, edges=True):
        a = rng.integers(0, n, shape).astype(np.int32)
        if edges:
            a[..., :6] = [-1, -(2**31), n, n + 5, 2**31 - 1, n - 1]
        return torch.from_numpy(a).to(dev)

    table, item_table, dom_table = (rand_table((n_rows, dim)), rand_table((n_rows, dim)),
                                    rand_table((n_dom, dim), 1e-4))
    dn_tables = (table, item_table, dom_table)
    ids = rand_ids(n_rows, batch)
    dn_ids = (ids, rand_ids(n_rows, batch), torch.full((batch,), 7, dtype=torch.int32,
                                                       device=dev))
    x_k, flats_k = gather_fields(dn_tables, dn_ids, train_mask=(True, True, True))
    x_p, flats_p = gather_fields_reference(dn_tables, dn_ids, train_mask=(True, True, True))
    torch.cuda.synchronize()
    k2_err = float((x_k - x_p).abs().max())
    if k2_err != 0.0 or not all(torch.equal(a, b) for a, b in zip(flats_k, flats_p)):
        fail(f"K2 differs from the plain field gather at the DN step's shape: max abs err "
             f"{k2_err}, row ids equal {[torch.equal(a, b) for a, b in zip(flats_k, flats_p)]}")
    print(f"K2 gather_fields vs plain [3 fields x {batch} ids: two {n_rows}x{dim} tables with 6 "
          f"ids out of range or at the edge, a {n_dom}x{dim} domain table with one id]: x "
          f"{tuple(x_k.shape)}, max abs err {k2_err} (tol 0: a gather is exact); the row ids "
          f"it wrote equal table_rows'")
    # K2's one-field case, which K3 is held to and timed beside (4b)
    got = embedding_lookup(table, ids)
    want = embedding_lookup_reference(table, ids)
    torch.cuda.synchronize()
    one_err = float((got - want).abs().max())
    if one_err != 0.0:
        fail(f"K2's one-field case differs from the plain gather: max abs err {one_err}")

    def replaced_route(tables, field_ids):
        """What a step did before K2 gathered fields: one launch a field
        (for a lane-stacked table the lane's clamp and offset first, on the
        host path), then torch.cat."""
        parts = []
        for t, i in zip(tables, field_ids):
            if t.dim() == 3:
                i = i.clamp(0, t.shape[1] - 1) + torch.arange(
                    t.shape[0], dtype=i.dtype, device=dev)[:, None] * t.shape[1]
            parts.append(embedding_lookup(t.reshape(-1, t.shape[-1]), i.reshape(-1))
                         .reshape(*i.shape, -1))
        return torch.cat(parts, dim=-1)

    turn = [0]

    def in_turn(fn, sets):
        turn[0] += 1
        return fn(sets[turn[0] % len(sets)])

    def field_timings(tables, sets, marked=mask):
        """Device ms a call over id sets taken in turn (so that a replay does
        not find the rows it read last time in the 50 MB L2; on the main path
        K1 runs between two gathers): K2, the route it replaces, the plain
        version, and the library composite (torch.cat of F.embedding calls
        on the clamped flat ids, made beforehand); ``marked``: the fields
        whose row ids are written (the trainable tables')."""
        views = [t.reshape(-1, t.shape[-1]) for t in tables]
        long_sets = [[table_rows(t, i)[1].long() for t, i in zip(tables, s)] for s in sets]
        library = lambda ls: torch.cat(  # noqa: E731
            [torch.nn.functional.embedding(i, v) for i, v in zip(ls, views)], dim=-1)
        return {
            "k2": device_ms(lambda: in_turn(
                lambda s: gather_fields(tables, s, train_mask=marked), sets), inner=48),
            "route": device_ms(lambda: in_turn(lambda s: replaced_route(tables, s), sets),
                               inner=48),
            "plain": device_ms(lambda: in_turn(
                lambda s: gather_fields_reference(tables, s, train_mask=marked), sets),
                inner=48),
            "library": device_ms(lambda: in_turn(library, long_sets), inner=48),
        }

    def field_bound(tables, sets, marked=mask):
        """The least bytes a call moves, averaged over the id sets: every
        table row its ids touch read once, the ids read, x and the marked
        fields' row ids written; and the rule that counts a row for every id
        (every row read, x written, the ids read)."""
        least = every = 0
        for s in sets:
            n_ids, width = s[0].numel(), sum(t.shape[-1] for t in tables)
            io = 4 * n_ids * (len(s) + width)
            least += io + 4 * n_ids * sum(marked) + sum(
                4 * t.shape[-1] * int(torch.unique(table_rows(t, i)[1]).numel())
                for t, i in zip(tables, s))
            every += io + 4 * n_ids * width
        return least / len(sets), every / len(sets)

    def timing_line(what, t, least, every):
        return (f"K2 time at {what} (4 id sets in turn): {t['k2'] * 1e3:.2f} us/call; the route "
                f"it replaces (3 one-field launches + torch.cat) {t['route'] * 1e3:.2f} us "
                f"({t['route'] / t['k2']:.2f}x K2); plain {t['plain'] * 1e3:.2f} us; torch.cat "
                f"of 3 F.embedding {t['library'] * 1e3:.2f} us; bound "
                f"{least / HBM_BYTES * 1e6:.3f} us ({least / 1e6:.3f} MB: rows touched once, "
                f"ids, x, row ids; {least / HBM_BYTES * 1e3 / t['k2'] * 100:.1f}% of it), "
                f"{every / HBM_BYTES * 1e6:.3f} us counting a row for every id "
                f"({every / 1e6:.3f} MB); {card}")

    dn_sets = [(rand_ids(n_rows, batch, False), rand_ids(n_rows, batch, False),
                torch.full((batch,), d, dtype=torch.int32, device=dev)) for d in (3, 11, 19, 27)]
    dn_t = field_timings(dn_tables, dn_sets)
    dn_least, dn_every = field_bound(dn_tables, dn_sets)
    k2_bound = dn_least / HBM_BYTES * 1e3
    print(timing_line(f"the DN step's shape ({batch} ids)", dn_t, dn_least, dn_every))
    # the one-field case at 1024 ids, for K3's comparison (4b)
    ids_long = ids.long().clamp(0, n_rows - 1)
    one_ms = device_ms(lambda: embedding_lookup(table, ids), inner=50)
    one_plain_ms = device_ms(lambda: embedding_lookup_reference(table, ids), inner=50)
    one_lib_ms = device_ms(lambda: torch.nn.functional.embedding(ids_long, table), inner=50)
    one_bytes = 4 * batch + 2 * 4 * batch * dim
    one_bound = one_bytes / HBM_BYTES * 1e3
    print(f"K2 one field, {batch} ids: {one_ms * 1e3:.2f} us/call; plain "
          f"{one_plain_ms * 1e3:.2f} us; F.embedding {one_lib_ms * 1e3:.2f} us; bound "
          f"{one_bound * 1e3:.3f} us ({one_bytes / 1e6:.3f} MB); {card}")

    # ---- 4a. K2 at the DR lane-step's shapes ----
    # 30 lanes x 1024 ids of three fields in one launch: the user and item
    # tables every lane shares, and a lane-stacked [30, 30, 128] domain table
    # (a lane's own), every lane with ids below 0 and past its own rows. Held
    # exactly against the plain version and against indexing each lane's
    # table on its own.
    lane_ids = rand_ids(n_rows, (lanes, batch))
    dom_stack = rand_table((lanes, n_dom, dim), 1e-2)
    dr_tables = (table, item_table, dom_stack)
    dr_ids = (lane_ids, rand_ids(n_rows, (lanes, batch)), rand_ids(n_dom, (lanes, batch)))
    before = gather_fields.launches
    x_k, flats_k = gather_fields(dr_tables, dr_ids, train_mask=(True, True, True))
    x_p, flats_p = gather_fields_reference(dr_tables, dr_ids, train_mask=(True, True, True))
    lane_of = torch.arange(lanes, device=dev)[:, None]
    alone = torch.cat([table[dr_ids[0].long().clamp(0, n_rows - 1)],
                       item_table[dr_ids[1].long().clamp(0, n_rows - 1)],
                       dom_stack[lane_of, dr_ids[2].long().clamp(0, n_dom - 1)]], dim=-1)
    torch.cuda.synchronize()
    k2l_err = max(float((x_k - x_p).abs().max()), float((x_k - alone).abs().max()))
    if (k2l_err != 0.0 or gather_fields.launches != before + 1
            or x_k.shape != (lanes, batch, 3 * dim)
            or not all(torch.equal(a, b) for a, b in zip(flats_k, flats_p))):
        fail(f"K2 at the lane step's shape differs from the plain field gather: {k2l_err}")
    print(f"K2 gather_fields vs plain [3 fields x {lanes * batch} ids over {lanes} lanes, 6 a "
          f"lane out of range or at the edge: two shared {n_rows}x{dim} tables and a "
          f"lane-stacked {lanes}x{n_dom}x{dim} domain table]: x {tuple(x_k.shape)}, max abs "
          f"err {k2l_err} (tol 0), also against indexing each lane's table; the row ids equal")
    # timed as the lane step runs it: a lane's batch is one domain's
    dr_sets = [(rand_ids(n_rows, (lanes, batch), False), rand_ids(n_rows, (lanes, batch), False),
                rand_ids(n_dom, (lanes, 1), False).expand(lanes, batch).contiguous())
               for _ in range(4)]
    dr_t = field_timings(dr_tables, dr_sets)
    dr_least, dr_every = field_bound(dr_tables, dr_sets)
    k2l_bound = dr_least / HBM_BYTES * 1e3
    print(timing_line(f"the DR lane-step's shape ({lanes * batch} ids)", dr_t, dr_least,
                      dr_every))
    # The eval lane-step's call (5c): the same fields and shapes, under
    # no_grad, no row ids written.
    ev_t = {"k2": device_ms(lambda: in_turn(lambda s: gather_fields(dr_tables, s), dr_sets),
                            inner=48),
            "plain": device_ms(lambda: in_turn(
                lambda s: gather_fields_reference(dr_tables, s), dr_sets), inner=48)}
    ev_least, _ = field_bound(dr_tables, dr_sets, (False, False, False))
    k2e_bound = ev_least / HBM_BYTES * 1e3
    print(f"K2 time at the eval lane-step's call ({lanes * batch} ids, no row ids written, 4 "
          f"id sets in turn): {ev_t['k2'] * 1e3:.2f} us/call; plain {ev_t['plain'] * 1e3:.2f} "
          f"us; bound {k2e_bound * 1e3:.3f} us ({ev_least / 1e6:.3f} MB); {card}")
    # the one-field case at 30720 ids, for K3's comparison (4b)
    id_sets = [s[0].reshape(-1) for s in dr_sets]
    long_sets = [i.long() for i in id_sets]
    one_l_ms = device_ms(lambda: in_turn(lambda i: embedding_lookup(table, i), id_sets),
                         inner=48)
    one_l_plain_ms = device_ms(
        lambda: in_turn(lambda i: embedding_lookup_reference(table, i), id_sets), inner=48)
    one_l_lib_ms = device_ms(
        lambda: in_turn(lambda i: torch.nn.functional.embedding(i, table), long_sets), inner=48)
    one_l_bytes = 4 * lanes * batch + 2 * 4 * lanes * batch * dim
    one_l_bound = one_l_bytes / HBM_BYTES * 1e3
    print(f"K2 one field, {lanes * batch} ids (4 id sets in turn): {one_l_ms * 1e3:.2f} us/call; "
          f"plain {one_l_plain_ms * 1e3:.2f} us; F.embedding {one_l_lib_ms * 1e3:.2f} us; bound "
          f"{one_l_bound * 1e3:.3f} us ({one_l_bytes / 1e6:.3f} MB); {card}")
    del dom_stack, x_k, x_p, alone, flats_k, flats_p, dn_sets, dr_sets

    # ---- 4b. K3 vs its plain version and vs K2 ----
    # k3_err[(k, ids)]: that launch against the plain version and against K2
    k3_err = {}
    for k in probe_gather.RING_DEPTHS:
        ring = gather_rows_pipelined(table, ids, k=k)
        torch.cuda.synchronize()
        k3_err[k, batch] = max(float((ring - want).abs().max()),
                               float((ring - got).abs().max()))
    short = gather_rows_pipelined(table, ids[:5], k=32)  # k = min(k, B)
    k3_err[32, 5] = float((short - want[:5]).abs().max())
    # 30720 ids, 6 a lane out of range: a block owns more rows than a ring of
    # 32 has slots, so its ring turns; and k larger than a block's rows
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    big_ids = lane_ids.reshape(-1)
    big_want = embedding_lookup_reference(table, big_ids)
    big_k2 = embedding_lookup(table, big_ids)
    plans = {k: ring_plan(big_ids.numel(), k, dim, sms) for k in (32, 128, 10_000)}
    if plans[32].rows_per_block <= plans[32].slots or plans[10_000].slots >= 10_000:
        fail(f"K3 at {big_ids.numel()} ids: the ring does not turn at k 32, or k 10000 "
             f"was not cut to a block's rows: {plans}")
    for k in plans:
        ring = gather_rows_pipelined(table, big_ids, k=k)
        torch.cuda.synchronize()
        k3_err[k, big_ids.numel()] = max(float((ring - big_want).abs().max()),
                                         float((ring - big_k2).abs().max()))
    plan_1024 = ring_plan(batch, 32, dim, sms)
    if any(k3_err.values()) or plan_1024.blocks < 64:
        fail(f"K3 differs from the plain gather or from K2 (max abs err by (k, ids) "
             f"{k3_err}), or its grid is too small ({plan_1024})")
    same_1024 = len({ring_plan(batch, k, dim, sms) for k in probe_gather.RING_DEPTHS}) == 1
    print(f"K3 gather_rows_pipelined vs plain and vs K2 [k {list(probe_gather.RING_DEPTHS)}, "
          f"the same {batch} ids on {plan_1024.blocks} blocks of {plan_1024.rows_per_block} "
          f"rows, a ring of {plan_1024.slots}"
          f"{' at either k: one and the same launch' if same_1024 else ''}; 5 ids with k 32; "
          f"{big_ids.numel()} ids, 6 a lane out of range or at the edge, at k 32 "
          f"({plans[32].blocks} blocks of {plans[32].rows_per_block} rows, a ring of "
          f"{plans[32].slots}), k 128 and k 10000 (cut to {plans[10_000].slots})]: "
          f"max abs err {max(k3_err.values())} (tol 0)")
    k3_ms = {k: device_ms(lambda k=k: gather_rows_pipelined(table, ids, k=k), inner=50)
             for k in probe_gather.RING_DEPTHS}
    print("K3 time at 1024 ids: "
          + ", ".join(f"k {k}: {v * 1e3:.2f} us/call" for k, v in k3_ms.items())
          + f"; K2's one-field case {one_ms * 1e3:.2f} us; F.embedding "
          f"{one_lib_ms * 1e3:.2f} us; bound {one_bound * 1e3:.3f} us; {card}")
    k3l_ms = {k: device_ms(
        lambda k=k: in_turn(lambda i: gather_rows_pipelined(table, i, k=k), id_sets), inner=48)
        for k in probe_gather.RING_DEPTHS}
    print(f"K3 time at {lanes * batch} ids (4 id sets in turn): "
          + ", ".join(f"k {k}: {v * 1e3:.2f} us/call" for k, v in k3l_ms.items())
          + f"; K2's one-field case {one_l_ms * 1e3:.2f} us; F.embedding "
          f"{one_l_lib_ms * 1e3:.2f} us; bound {one_l_bound * 1e3:.3f} us; {card}")
    print("K3 at 1024 ids, before and after its redesign: "
          + ", ".join(f"k {k}: {EARLIER_US[f'K3 k {k}']:.2f} us (recorded) -> "
                      f"{k3_ms[k] * 1e3:.2f} us" for k in probe_gather.RING_DEPTHS)
          + f"; {card}")
    del id_sets, long_sets, big_want, big_k2
    # K3's path is the gather probe, as in the JAX package: drive it and
    # count K3's launches on it, per ring depth and size.
    gather_rows_pipelined.launches = 0
    probe_rows = probe_gather.run()
    k3_launches = {(r.k, r.ids): r.k3_launches for r in probe_rows if r.k is not None}
    if (min(k3_launches.values()) < 1
            or sum(k3_launches.values()) != gather_rows_pipelined.launches
            or set(k3_launches) != {(k, n) for k in probe_gather.RING_DEPTHS
                                    for n in (batch, lanes * batch)}
            or not all(np.isfinite(r.ns_per_row) and r.ns_per_row > 0 for r in probe_rows)):
        fail(f"the gather probe launched K3 {k3_launches} (k, ids): {probe_rows}")
    print(f"gather probe: K3 launched {gather_rows_pipelined.launches}x; by (k, ids) "
          f"{ {f'k {k}, {n} ids': v for (k, n), v in k3_launches.items()} }")
    del table, item_table, dn_tables, dr_tables, got, want, ring

    # ---- 5. the slice at bench.py's shapes ----
    t0 = time.perf_counter()
    ckpt_root = tempfile.mkdtemp(prefix="mamdr_chip_smoke_")  # checkpoints of 5c
    trainer, strat = build_bench_strategy(checkpoint_path=ckpt_root)  # no device: the card
    ds, n_domain = trainer.dataset, trainer.dataset.n_domain
    torch.cuda.synchronize()
    print(f"slice set-up: {time.perf_counter() - t0:.1f} s (dataset, tables, trainer, "
          f"{n_domain} specific draws, device block)")

    def hold_step(build, kernel, plain, state, cols, measure=None):
        """One step through the kernels against the same step through the
        independent plain versions; build(tower_grad, gather) -> step. Rows
        where K1 and the plain version take a ReLU unit differently (counted,
        each at 0 within rounding) get weight 0 in both. Compared: the loss
        and the optimizer's new moments mu, nu (linear and quadratic in the
        gradient), or what ``measure(state, loss)`` picks. The parameters
        themselves are Adam's normalisation of mu/nu, which turns last-bit
        differences of near-zero gradients into steps of order lr, so under
        Adam they are not a measure of the kernels. Also returns K1's
        operands in the step through the kernels."""
        seen = []

        def spy(*a):
            seen[:] = a
            return kernel(*a)

        def moments(s, loss):
            return [loss, s.opt_state.mu, s.opt_state.nu]

        moments = measure or moments

        step_p = build(plain, gather_fields_reference)
        s_k, l_k = build(spy, gather_fields)(state, cols)
        s_p, l_p = step_p(state, cols)
        _, rel = worst_errors(moments(s_k, l_k), moments(s_p, l_p))
        note = ""
        rows, flips = k1_flip_rows(*seen)
        if flips:
            note = (f"{flips} ReLU units on the edge in {int(rows.sum())} rows set aside "
                    f"(with none set aside: {rel:.2e})")
            cols = {**cols, "weight": torch.where(rows, 0.0, cols["weight"])}
            s_k, l_k = build(kernel, gather_fields)(state, cols)
            s_p, l_p = step_p(state, cols)
            _, rel = worst_errors(moments(s_k, l_k), moments(s_p, l_p))
        if not rel <= K1_REL_TOL:
            fail(f"step through the kernels and through the plain versions differ by {rel} "
                 f"of a tensor's max; {note}")
        return s_k, l_k, l_p, rel, flips, note or "no ReLU unit on the edge", seen

    # One train step on the first batch of domain 0.
    batch0 = {k: v[0, :batch].contiguous() for k, v in strat._block.items()}
    s_k, l_k, l_p, step_err, _, step_note, _ = hold_step(
        lambda tower, gather: make_train_step(
            trainer.model, trainer.tx, trainer.step_cfg,
            loss_grad=make_fast_loss_grad(trainer.model, trainer.step_cfg,
                                          tower_grad=tower, gather=gather)),
        fused_tower_grad, tower_grad_reference, trainer.state, batch0)
    if int(s_k.step) != 1 or not all(bool(torch.isfinite(p).all())
                                     for p in trees.leaves(s_k.params)):
        fail("train step through the kernels did not give one finite step")
    print(f"train step, kernels vs plain versions: loss {float(l_k):.6f} vs {float(l_p):.6f}, "
          f"largest difference in loss, mu, nu {step_err:.2e} of the tensor's max "
          f"(tol {K1_REL_TOL}); {step_note}")

    shared0 = strat.shared
    steps = sum(trainer.steps_per_domain())
    n_examples = sum(s.n for s in ds.train)
    fused_tower_grad.launches = 0
    gather_fields.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = strat.run_dn_phase()  # ends in the phase's one host sync
    dn_s = time.perf_counter() - t0
    k1_launches = fused_tower_grad.launches
    k2_launches = gather_fields.launches  # one field gather a step writes x
    if k1_launches != steps or k2_launches != steps:
        fail(f"DN phase launched K1 {k1_launches}x and K2 {k2_launches}x, "
             f"expected {steps} and {steps}")
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

    # ---- 5b. the DR phase of the same epoch, as query-domain lanes ----
    if not strat.dr_lanes:
        fail("dr_parallel 'auto' did not take the lanes on this card")
    tc = trainer.config.train
    spd = trainer.steps_per_domain()
    cap = tc.domain_regulation_step

    def capped(n):
        return min(n, cap) if cap > 0 else n

    # per support run: the longest support epoch and the longest (capped)
    # query epoch over the lanes
    lane_steps = sum(max(spd[s] for s in strat.aux[:, j])
                     + max(capped(spd[q]) for q in strat.order)
                     for j in range(strat.aux.shape[1]))
    last_lane_steps = sum(spd[s] + capped(spd[int(strat.order[-1])]) for s in strat.aux[-1])
    dr_examples = sum(ds.train[s].n + min(ds.train[q].n, capped(spd[q]) * batch)
                      for q, row in zip(strat.order, strat.aux) for s in row)
    entry_step = int(trainer.state.step)
    spec0 = list(strat.specific)
    frozen0 = {n: x for n, x in trees.leaves_with_names(trainer.state.params)
               if "user_emb" in n or "item_emb" in n}
    fused_tower_grad.launches = fused_tower_grad_lanes.launches = 0
    gather_fields.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    strat.run_dr_phase()
    torch.cuda.synchronize()
    dr_s = time.perf_counter() - t0
    k1l_launches = fused_tower_grad_lanes.launches
    k2_dr_launches = gather_fields.launches  # one field gather a lane-step writes x
    if (k1l_launches != lane_steps or k2_dr_launches != lane_steps
            or fused_tower_grad.launches != 0):
        fail(f"DR phase launched K1-lanes {k1l_launches}x, K2 {k2_dr_launches}x and "
             f"single-lane K1 {fused_tower_grad.launches}x; expected {lane_steps}, "
             f"{lane_steps} and 0")
    if int(trainer.state.step) != entry_step + last_lane_steps:
        fail(f"state.step {int(trainer.state.step)} after DR, expected "
             f"{entry_step} + {last_lane_steps}")
    for d_idx, (new, old) in enumerate(zip(strat.specific, spec0)):
        for (n, m), a, b in zip(trees.leaves_with_names(strat.mask), trees.leaves(new),
                                trees.leaves(old)):
            if m and (not bool(torch.isfinite(a).all()) or torch.equal(a, b)):
                fail(f"DR left specific[{d_idx}] {n} unchanged or not finite")
    for tree, what in ((trainer.state.params, "params"), (strat.shared, "shared"),
                       (strat._spec_stack, "specific stack"), (strat.specific[0], "specific")):
        for n, x in trees.leaves_with_names(tree):
            if n in frozen0 and x is not frozen0[n]:
                fail(f"{what}: the frozen table {n} is no longer the same tensor")
    print(f"DR phase: {n_domain} lanes, {lane_steps} lane-steps "
          f"({strat.aux.shape[1]} support runs), K1-lanes launched {k1l_launches}x, "
          f"K2 {k2_dr_launches}x; every domain's specific updated and finite; frozen "
          f"tables shared; step {entry_step} -> {int(trainer.state.step)}")
    print(f"DR phase time: {dr_s:.3f} s, {lane_steps} lane-steps, {dr_examples} examples, "
          f"{dr_examples / dr_s:.0f} examples/s, {dr_s / lane_steps * 1e3:.3f} ms/lane-step; "
          f"{card}")
    # A second epoch through run_fused_epoch, the entry point a training loop
    # calls: one host sync at its end, examples counted as above.
    epoch_examples = n_examples + dr_examples  # DR's count holds for any draw here:
    if len({s.n for s in ds.train}) != 1:      # every domain has as many rows
        fail("the bench workload's domains are no longer balanced")
    t0 = time.perf_counter()
    epoch_losses = strat.run_fused_epoch()
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    if not np.all(np.isfinite(epoch_losses)) or int(trainer.state.step) != (
            entry_step + last_lane_steps + steps + last_lane_steps):
        fail(f"run_fused_epoch: losses {epoch_losses}, step {int(trainer.state.step)}")
    print(f"MAMDR epoch (run_fused_epoch, DN + DR): {epoch_s:.3f} s, {epoch_examples} "
          f"examples, {epoch_examples / epoch_s:.0f} examples/s (the two phases timed "
          f"apart above: {dn_s + dr_s:.3f} s); {card}")

    # One DR lane-step through the kernels vs the same lane-step through the
    # plain versions: every lane its own merged weights, seeds and batch.
    frozen_mask = trainer.frozen_mask()
    _, to_sub, _ = make_subset_train_step(
        trainer.model, trainer.tx, trainer.step_cfg, frozen_mask, trainer.state.params)
    lane_state = fused.make_lane_state(trainer.state, to_sub(trainer.state.params),
                                       strat.mask, n_domain)
    merged = weight_ops.merge_weights(to_sub(strat.shared), strat._spec_stack, strat.mask,
                                      tc.merged_method)
    lane_state = lane_state.replace(
        params=weight_ops.load_masked(lane_state.params, merged, strat.mask))
    lane_batch = {k: v[:, :batch].contiguous() for k, v in strat._block.items()}
    k1l_before = fused_tower_grad_lanes.launches
    s_k, l_k, l_p, lane_step_err, lane_step_flips, lane_step_note, _ = hold_step(
        lambda tower, gather: make_subset_train_step(
            trainer.model, trainer.tx, trainer.step_cfg, frozen_mask, trainer.state.params,
            loss_grad=make_fast_loss_grad(trainer.model, trainer.step_cfg,
                                          tower_grad=tower, gather=gather))[0],
        fused_tower_grad_lanes, tower_grad_reference_lanes, lane_state, lane_batch)
    if fused_tower_grad_lanes.launches != k1l_before + 1 + bool(lane_step_flips):
        fail("the DR lane-step did not launch K1-lanes exactly once")
    if l_k.shape != (n_domain,) or s_k.opt_state.mu.shape[0] != n_domain:
        fail(f"DR lane-step: {tuple(l_k.shape)} losses for {n_domain} lanes")
    if not bool(torch.all(s_k.step == lane_state.step + 1)):
        fail("DR lane-step through the kernels did not advance every lane by one step")
    print(f"DR lane-step, kernels vs plain versions: {n_domain} losses (mean "
          f"{float(l_k.mean()):.6f} vs {float(l_p.mean()):.6f}), largest difference in "
          f"loss, mu, nu {lane_step_err:.2e} of the tensor's max (tol {K1_REL_TOL}); "
          f"{lane_step_note}")

    # ---- 5c. after the epoch: validation and best snapshot, test, finetune ----
    # Each path driven with the launch counts at 0 just before it and read
    # just after; every domain is a lane in the evals (val and test splits
    # 4000 rows a domain: 4 lane-steps) and in the finetune (12000 train rows
    # a domain: 12 lane-steps an epoch, SGD at lr 1e-3).
    val_rows, test_rows = sum(s.n for s in ds.val), sum(s.n for s in ds.test)
    val_steps = max(trainer.eval_steps_per_domain("val"))
    test_steps = max(trainer.eval_steps_per_domain("test"))
    ft_steps = max(spd)

    def zero_counts():
        fused_tower_grad.launches = fused_tower_grad_lanes.launches = 0
        gather_fields.launches = gather_fields.lane_launches = 0
        torch.cuda.synchronize()

    def counts():
        torch.cuda.synchronize()
        return fused_tower_grad.launches, fused_tower_grad_lanes.launches, gather_fields.launches

    def k2_split():
        """K2's launches since zero_counts(), as its wrapper counted them: (with
        ids [B], the one-tower steps; with ids [L, B], the lane-steps and evals)."""
        torch.cuda.synchronize()
        return (gather_fields.launches - gather_fields.lane_launches,
                gather_fields.lane_launches)

    def checked(res, mode, what):
        """(macro AUC, weighted AUC) of a result; every domain's AUC finite
        in [0, 1] and its loss finite."""
        avg_loss, avg_auc, dl, da = res
        if (len(da) != n_domain or len(dl) != n_domain
                or not all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in da.values())
                or not all(np.isfinite(v) for v in dl.values())):
            fail(f"{what}: losses {dl}, AUCs {da}")
        return avg_auc, trainer.weighted_auc(mode, da), avg_loss

    zero_counts()
    t0 = time.perf_counter()
    stopped = strat.epoch_tail(0)  # validation, early stop, best snapshot
    tail_s = time.perf_counter() - t0
    if (counts() != (0, 0, val_steps) or stopped or strat.best_shared is not strat.shared
            or trainer.best_params is None or not os.path.exists(trainer.checkpoint_path)
            or not os.path.exists(os.path.join(trainer.checkpoint_dir, "decomposition",
                                               "meta.json"))):
        fail(f"epoch tail: launches (K1, K1-lanes, K2) {counts()}, expected (0, 0, "
             f"{val_steps}); stopped {stopped}; or no best snapshot and checkpoint")
    print(f"epoch tail (merged validation, early stop, best snapshot and its checkpoint "
          f"files): {tail_s:.3f} s, K2 launched {val_steps}x, K1 0x; {card}")

    zero_counts()
    t0 = time.perf_counter()
    val_res = strat.validate()  # ends in the eval's one host read
    val_s = time.perf_counter() - t0
    val_counts = counts()
    if val_counts != (0, 0, val_steps):
        fail(f"merged validation launched (K1, K1-lanes, K2) {val_counts}, expected "
             f"(0, 0, {val_steps})")
    val_auc, val_wauc, val_loss = checked(val_res, "val", "merged validation")
    print(f"merged validation: {n_domain} domains as lanes, {val_steps} lane-steps, K2 "
          f"launched {val_counts[2]}x, K1 0x; {val_s:.3f} s, {val_rows} rows, "
          f"{val_rows / val_s:.0f} examples/s; macro AUC {val_auc:.6f}, weighted "
          f"{val_wauc:.6f}, loss {val_loss:.6f}; {card}")

    # The eval through K2 against the same eval through the plain gather: K2
    # copies rows, the products are the same calls, so bit for bit.
    spec_stack = fused.stack_specific(strat.specific, strat.mask)
    lane_params = weight_ops.load_masked(
        trainer.state.params,
        weight_ops.merge_weights(strat.shared, spec_stack, strat.mask, tc.merged_method),
        strat.mask)
    vblock = trainer.eval_block("val")
    vb = {k: v[:, 0].contiguous() for k, v in vblock.items()}
    logits_k = trainer.model.apply_lanes(lane_params["model"], vb["uid"], vb["pid"], vb["domain"])
    logits_p = trainer.model.apply_lanes(lane_params["model"], vb["uid"], vb["pid"], vb["domain"],
                                         gather=gather_fields_reference)
    loss_k, counts_k = fused.make_lane_eval(trainer.model, trainer.step_cfg)(lane_params, vblock)
    loss_p, counts_p = fused.make_lane_eval(trainer.model, trainer.step_cfg,
                                            gather=gather_fields_reference)(lane_params, vblock)
    eval_err = float((logits_k - logits_p).abs().max())
    if (not torch.equal(logits_k, logits_p) or not torch.equal(loss_k, loss_p)
            or not all(torch.equal(a, b) for a, b in zip(counts_k, counts_p))
            or [float(v) for v in loss_k.cpu()] != [val_res[2][str(d)] for d in range(n_domain)]):
        fail(f"the eval through K2 differs from the eval through the plain gather (logits max "
             f"abs err {eval_err}) or from validate()")
    n_pos = int(counts_k.true_positives[:, 0].sum() + counts_k.false_negatives[:, 0].sum())
    print(f"eval lane-step through K2 vs the plain gather: the logits of a [{n_domain}, {batch}] "
          f"lane-step, every lane's loss and its 4 x 500 confusion counts over the split "
          f"({n_pos} positive of {val_rows} rows) bit-equal (tol 0), and equal to validate()'s")

    zero_counts()
    t0 = time.perf_counter()
    test_res = strat.test()
    test_s = time.perf_counter() - t0
    test_counts = counts()
    if test_counts != (0, 0, test_steps):
        fail(f"test launched (K1, K1-lanes, K2) {test_counts}, expected (0, 0, {test_steps})")
    test_auc, test_wauc, test_loss = checked(test_res, "test", "test")
    print(f"test with the best snapshot: {test_steps} lane-steps, K2 launched "
          f"{test_counts[2]}x; {test_s:.3f} s, {test_rows} rows, {test_rows / test_s:.0f} "
          f"examples/s; macro AUC {test_auc:.6f}, weighted {test_wauc:.6f}, loss "
          f"{test_loss:.6f}; {card}")

    zero_counts()
    t0 = time.perf_counter()
    ft_res = strat.finetune()
    ft_s = time.perf_counter() - t0
    ft_counts = counts()
    want = (0, ft_steps * tc.epoch, (ft_steps + val_steps) * tc.epoch + test_steps)
    if ft_counts != want:
        fail(f"finetune launched (K1, K1-lanes, K2) {ft_counts}, expected {want}")
    ft_auc, ft_wauc, ft_loss = checked(ft_res, "test", "finetune")
    for d in range(n_domain):
        with np.load(os.path.join(trainer.checkpoint_dir, f"domain_{d}.npz")) as z:
            kernel = z["model//dnn//Dense_0//Dense_0//kernel"]
        start = strat._best_params_fn(d)["model"]["dnn"]["Dense_0"]["Dense_0"]["kernel"]
        if not np.all(np.isfinite(kernel)) or np.array_equal(kernel, start.cpu().numpy()):
            fail(f"finetune: domain {d}'s best weights are not finite or did not move")
    print(f"finetune ({tc.epoch} epoch of {ft_steps} lane-steps, val, test): {ft_s:.3f} s, "
          f"K1-lanes launched {ft_counts[1]}x, K2 {ft_counts[2]}x, K1 0x; every domain's "
          f"best weights moved; test macro AUC {ft_auc:.6f}, weighted {ft_wauc:.6f}, loss "
          f"{ft_loss:.6f}; {card}")

    # One finetune lane-step through the kernels vs the plain versions (SGD
    # keeps no moments: the loss and the new params are compared; their
    # change, lr * g, is too small beside the params to subtract out in
    # float32), and K1 held to its plain version on that lane-step's
    # operands, which holds the gradients; then one finetune epoch timed on
    # its own.
    lanes_ft = separate.make_lanes(trainer, False, strat._best_params_fn)
    first = {k: v[:, :batch].contiguous() for k, v in lanes_ft.block.items()}

    def sgd_change(s, loss):
        return [loss, *(a for a in trees.leaves(s.params) if a.dim() > 0)]

    _, _, _, ft_step_err, _, ft_step_note, seen = hold_step(
        lambda tower, gather: make_subset_train_step(
            trainer.model, trainer.finetune_tx, trainer.step_cfg, trainer.frozen_mask(),
            trainer.state.params,
            loss_grad=make_fast_loss_grad(trainer.model, trainer.step_cfg,
                                          tower_grad=tower, gather=gather))[0],
        fused_tower_grad_lanes, tower_grad_reference_lanes, lanes_ft.states, first,
        measure=sgd_change)
    k1f = k1_vs_plain(fused_tower_grad_lanes, tower_grad_reference_lanes, *seen, K1_REL_TOL)
    print(f"finetune lane-step (SGD), kernels vs plain versions: largest difference in loss "
          f"and the new params {ft_step_err:.2e} of the tensor's max (tol {K1_REL_TOL}); "
          f"{ft_step_note}; K1-lanes on its operands: {report(k1f)}")
    zero_counts()
    t0 = time.perf_counter()
    ft_states, ft_losses = lanes_ft.epoch_all(lanes_ft.states, lanes_ft.block, trainer.gen)
    ft_epoch_counts = counts()
    ft_epoch_s = time.perf_counter() - t0
    if ft_epoch_counts != (0, ft_steps, ft_steps) or not bool(torch.isfinite(ft_losses).all()):
        fail(f"finetune epoch: launches (K1, K1-lanes, K2) {ft_epoch_counts}, expected "
             f"(0, {ft_steps}, {ft_steps}); losses {ft_losses}")
    for (n, a), b in zip(trees.leaves_with_names(ft_states.params),
                         trees.leaves(lanes_ft.states.params)):
        if a.dim() > 0 and not bool((a != b).flatten(1).any(1).all()):
            fail(f"finetune epoch: {n} did not move in every lane")
    _, ft_val = lanes_ft.eval_all(ft_states.params, lanes_ft.val_block, lanes_ft.val_steps)
    ft_val_auc = {str(d): float(v) for d, v in enumerate(ft_val.cpu())}
    n_train = sum(s.n for s in ds.train)
    print(f"finetune epoch: {ft_steps} lane-steps, K1-lanes {ft_epoch_counts[1]}x, K2 "
          f"{ft_epoch_counts[2]}x; {ft_epoch_s:.3f} s, {n_train} rows, "
          f"{n_train / ft_epoch_s:.0f} examples/s, {ft_epoch_s / ft_steps * 1e3:.3f} "
          f"ms/lane-step; every lane's params moved; val macro AUC after it "
          f"{np.mean(list(ft_val_auc.values())):.6f}, weighted "
          f"{trainer.weighted_auc('val', ft_val_auc):.6f}; {card}")

    # The whole flow as a user calls it, on a fresh strategy (untimed set-up;
    # kernels already built): train (tc.epoch epochs, each with its
    # validation, early stop and best snapshot), test with the best weights,
    # finetune. With no early-stop history the first validation improves, so
    # the run writes the snapshot once.
    del lanes_ft, ft_states, lane_params, spec_stack, vblock, first, seen, trainer, strat
    trainer, strat = build_bench_strategy(checkpoint_path=os.path.join(ckpt_root, "run"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_res = strat.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    run_auc, run_wauc, run_loss = checked(run_res, "test", "run()")
    if trainer.stopper.best_metric is None or not os.path.exists(trainer.checkpoint_path):
        fail("run() on a fresh strategy wrote no best snapshot")
    print(f"run() on a fresh strategy ({tc.epoch} MAMDR epoch with its validation, early stop "
          f"and one best snapshot written, test, finetune): {run_s:.3f} s; finetuned test "
          f"macro AUC {run_auc:.6f}, weighted {run_wauc:.6f}, loss {run_loss:.6f}; {card}")
    del trainer, strat

    # A small input against the reference: the same run() on the CPU through
    # the plain versions (one batch a domain, so the two devices' shuffles
    # permute the same rows; dropout off).
    def small_run(device):
        cfg = ExperimentConfig.from_dict({
            "model": {"name": "mlp_meta_mamdr_finetune", "user_dim": 8, "item_dim": 8,
                      "domain_dim": 8, "hidden_dim": [32, 16], "dropout": 0.0},
            "train": {"load_pretrain_emb": True, "emb_trainable": False, "epoch": 3,
                      "patience": 2, "learning_rate": 1e-2, "meta_learning_rate": 0.1,
                      "sample_num": 2, "checkpoint_path": os.path.join(ckpt_root, str(device))},
            "dataset": {"name": "synthetic", "batch_size": 64, "seed": 21}})
        small = make_synthetic_dataset(n_domain=3, n_uid=50, n_pid=60, n_per_domain=100,
                                       seed=21, long_tail=True, batch_size=64)
        r = np.random.default_rng(0)
        small.user_emb = r.normal(0, 0.1, (50, 8)).astype(np.float32)
        small.item_emb = r.normal(0, 0.1, (60, 8)).astype(np.float32)
        return MAMDRStrategy(Trainer(cfg, small, device=device, verbose=False)).run()

    small_card, small_cpu = small_run(None), small_run("cpu")
    loss_rel = max(abs(small_card[2][k] - v) / abs(v) for k, v in small_cpu[2].items())
    auc_abs = max(abs(small_card[3][k] - v) for k, v in small_cpu[3].items())
    if not (loss_rel <= 1e-3 and auc_abs <= 1e-3):
        fail(f"small run() on the card vs the CPU: test losses {small_card[2]} vs "
             f"{small_cpu[2]}, AUCs {small_card[3]} vs {small_cpu[3]}")
    print(f"small run() (3 domains, 3 epochs, finetune) on the card vs the CPU's plain "
          f"versions: test loss within {loss_rel:.2e} (tol 1e-3 relative), AUC within "
          f"{auc_abs:.2e} (tol 1e-3)")
    shutil.rmtree(ckpt_root, ignore_errors=True)

    # ---- 5d. file-backed data, the CLI, joint / separate / finetune / DN / Reptile ----
    # The bench data written in the reference's on-disk layout and read back
    # by MultiDomainDataset.from_disk through the native CSV loader (bit for
    # bit); the CLI as a user starts it, on that tree; then each new
    # strategy's run() at bench shapes on the loaded data, every path driven
    # with the launch counts at 0 just before it and read just after; and a
    # small run() of each on the card against the CPU.
    from mamdr_tpu_torch.data import native_loader
    from mamdr_tpu_torch.data.dataset import MultiDomainDataset
    from mamdr_tpu_torch.strategies.base import build_strategy
    from mamdr_tpu_torch.workload import (bench_config, bench_dataset, build_bench_trainer,
                                          write_domain_tree)

    work = tempfile.mkdtemp(prefix="mamdr_chip_smoke_5d_")
    mem = bench_dataset()
    mem.ctr_ratio = {0: float(mem.train[0].label.mean())}
    split = "split_by_theme_30"
    t0 = time.perf_counter()
    write_domain_tree(mem, os.path.join(work, "Taobao", split))
    write_s = time.perf_counter() - t0
    ds_conf = ExperimentConfig.from_dict({"dataset": {
        "name": "Taobao", "dataset_path": os.path.join(work, "Taobao"),
        "domain_split_path": split, "batch_size": batch, "seed": 123}}).dataset
    files0 = native_loader.load_csv_native.files
    t0 = time.perf_counter()
    disk = MultiDomainDataset.from_disk(ds_conf)
    load_s = time.perf_counter() - t0
    n_files = native_loader.load_csv_native.files - files0
    if n_files != 3 * mem.n_domain:
        fail(f"from_disk parsed {n_files} of {3 * mem.n_domain} CSV files natively")
    for mode in ("train", "val", "test"):
        for d, (a, b) in enumerate(zip(getattr(disk, mode), getattr(mem, mode))):
            for col in ("uid", "pid", "domain", "label"):
                x, y = getattr(a, col), getattr(b, col)
                if x.dtype != y.dtype or not np.array_equal(x, y):
                    fail(f"from_disk: {mode} domain {d} column {col} differs from the data")
    for what, x, y in (("user", disk.user_emb, mem.user_emb), ("item", disk.item_emb,
                                                                mem.item_emb)):
        if x.dtype != y.dtype or not np.array_equal(x, y):
            fail(f"from_disk: the {what} table differs from the data")
    if disk.dataset_info != mem.dataset_info:
        fail("from_disk: dataset_info differs")
    disk_rows = sum(s.n for m in ("train", "val", "test") for s in getattr(disk, m))
    print(f"file-backed data: wrote {mem.n_domain} domains x 3 CSV files and two "
          f"{mem.n_uid}x128 emb JSON tables in {write_s:.3f} s; from_disk {load_s:.3f} s, "
          f"{disk_rows} rows ({disk_rows / load_s:.0f} rows/s) and {2 * mem.n_uid} table "
          f"rows, {n_files} files through the native loader; every column and both tables "
          f"bit-equal to the in-memory data")
    del mem

    # The CLI as a user runs it, in its own process, on the tree.
    cli_cfg = bench_config(model="mlp_meta_mamdr_finetune").to_dict()
    cli_cfg["dataset"].update(name="Taobao", dataset_path=os.path.join(work, "Taobao"),
                              domain_split_path=split)
    cli_cfg["train"].update(checkpoint_path=os.path.join(work, "cli_ckpt"),
                            result_save_path=os.path.join(work, "cli_result"))
    cli_json = os.path.join(work, "cli.json")
    with open(cli_json, "w") as f:
        json.dump(cli_cfg, f)
    repo = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "mamdr_tpu_torch.run", "--config", cli_json],
        cwd=repo, env={**os.environ, "PYTHONPATH": repo}, capture_output=True, text=True,
        timeout=600)
    cli_s = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"the CLI exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    res_base = os.path.join(work, "cli_result", "mlp_meta_mamdr_finetune", "Taobao", split)
    folders = os.listdir(res_base) if os.path.isdir(res_base) else []
    if len(folders) != 1:
        fail(f"the CLI wrote {len(folders)} result folders under {res_base}")
    res_dir = os.path.join(res_base, folders[0])
    if sorted(os.listdir(res_dir)) != ["config.json.example", "dataset_info.json",
                                       "model_parameters.npz", "result.json"]:
        fail(f"the CLI's result folder holds {sorted(os.listdir(res_dir))}")
    with open(os.path.join(res_dir, "result.json")) as f:
        cli_res = json.load(f)
    vals = [cli_res["avg_loss"], cli_res["avg_auc"], *cli_res["domain_loss"].values(),
            *cli_res["domain_auc"].values()]
    if len(cli_res["domain_auc"]) != n_domain or not all(np.isfinite(v) for v in vals):
        fail(f"the CLI's result.json: {cli_res}")
    with np.load(os.path.join(res_dir, "model_parameters.npz")) as z:
        names = sorted(z.files)
    want_names = ["model//dnn//Dense_0//Dense_0//kernel", "model//embedding//user_emb",
                  "model//logit//Dense_0//Dense_0//kernel"]
    if not all(n in names for n in want_names):
        fail(f"the CLI's model_parameters.npz holds {names}")
    print(f"CLI (python -m mamdr_tpu_torch.run --config, mlp_meta_mamdr_finetune, epoch 1, "
          f"on the tree, its own process): exit 0 in {cli_s:.3f} s wall (start-up, "
          f"from_disk, run(), result folder); result folder {folders[0]} with its four "
          f"files, test macro AUC {cli_res['avg_auc']:.6f}, loss {cli_res['avg_loss']:.6f}; "
          f"{len(names)} flax-named arrays in model_parameters.npz; {card}")

    # The new strategies' run() at bench shapes on the loaded data, epoch 1.
    # Each train epoch is timed apart by wrapping the epoch function its
    # strategy builds; an epoch is 360,000 examples (30 domain-epochs of
    # 12000, counted as bench.py counts a domain-epoch).
    epoch_s_of = []

    def timed(factory, index=None):
        def make(*a, **k):
            out = factory(*a, **k)
            fn = out if index is None else out[index]

            def run_timed(*aa, **kk):
                torch.cuda.synchronize()
                t0_ = time.perf_counter()
                r = fn(*aa, **kk)
                torch.cuda.synchronize()
                epoch_s_of.append(time.perf_counter() - t0_)
                return r

            return run_timed if index is None else (run_timed, *out[1:])

        return make

    originals = {k: getattr(fused, k) for k in ("make_fused_passes", "make_fused_dn",
                                                "make_fused_reptile", "make_fused_separate")}
    fused.make_fused_passes = timed(originals["make_fused_passes"])
    fused.make_fused_dn = timed(originals["make_fused_dn"])
    fused.make_fused_reptile = timed(originals["make_fused_reptile"])
    fused.make_fused_separate = timed(originals["make_fused_separate"], 0)
    new_counts = {}
    disk_train = sum(s.n for s in disk.train)
    try:
        for name in ("mlp", "mlp_finetune", "mlp_separate",
                     "mlp_meta_domain_negotiation_finetune", "mlp_meta_reptile_finetune"):
            trainer = build_bench_trainer(name, checkpoint_path=os.path.join(work, name),
                                          dataset=disk)
            strat = build_strategy(trainer)
            params0 = trainer.state.params
            train_steps = sum(trainer.steps_per_domain())
            ev = max(trainer.eval_steps_per_domain("val"))
            te = max(trainer.eval_steps_per_domain("test"))
            ln = max(trainer.steps_per_domain())
            lanes_k2 = ln + ev + te  # one epoch of lanes, its validation, the test
            if name == "mlp_separate":
                want = (0, ln, lanes_k2)
            else:
                ft = strat.spec.finetune
                want = (train_steps, ln if ft else 0,
                        train_steps + ev + te + (lanes_k2 if ft else 0))
            epoch_s_of.clear()
            zero_counts()
            t0 = time.perf_counter()
            res = strat.run()
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            got = counts()
            if got != want:
                fail(f"{name}: run() launched (K1, K1-lanes, K2) {got}, expected {want}")
            split = k2_split()
            if split != (want[0], want[2] - want[0]):
                fail(f"{name}: K2 launched {split} times with ids [B] and [L, B], expected "
                     f"{(want[0], want[2] - want[0])}")
            new_counts[name] = (*got, *split)
            auc, wauc, loss = checked(res, "test", f"{name} run()")
            start = params0["model"]["dnn"]["Dense_0"]["Dense_0"]["kernel"]
            if name == "mlp_separate" or strat.spec.finetune:
                for d in range(n_domain):
                    with np.load(os.path.join(trainer.checkpoint_dir, f"domain_{d}.npz")) as z:
                        k = z["model//dnn//Dense_0//Dense_0//kernel"]
                    if not np.all(np.isfinite(k)) or np.array_equal(k, start.cpu().numpy()):
                        fail(f"{name}: domain {d}'s best weights are not finite or did not move")
            if name != "mlp_separate":
                best = trainer.best_params["model"]["dnn"]["Dense_0"]["Dense_0"]["kernel"]
                if not bool(torch.isfinite(best).all()) or torch.equal(best, start):
                    fail(f"{name}: the trained weights are not finite or did not move")
            if hasattr(strat, "meta"):
                for (n, m), a, b in zip(trees.leaves_with_names(strat.mask),
                                        trees.leaves(strat.meta), trees.leaves(params0)):
                    if m and (torch.equal(a, b) or not bool(torch.isfinite(a).all())):
                        fail(f"{name}: meta leaf {n} did not move or is not finite")
                    if not m and a is not b:
                        fail(f"{name}: meta's unmasked leaf {n} is not the same tensor")
            # the train epoch, then the finetune stage's epoch of lanes
            if len(epoch_s_of) != 1 + strat.spec.finetune:
                fail(f"{name}: {len(epoch_s_of)} epochs timed, expected "
                     f"{1 + strat.spec.finetune}")
            ep_s = epoch_s_of[0]
            ft_note = (f"; its finetune epoch {epoch_s_of[1]:.3f} s" if strat.spec.finetune
                       else "")
            what = ("every domain a lane: an epoch, validation, test" if name == "mlp_separate"
                    else "an epoch, validation, best checkpoint, test"
                    + (", finetune" if strat.spec.finetune else ""))
            print(f"{name} run() at bench shapes on the loaded data ({what}): {run_s:.3f} s; "
                  f"its train epoch {ep_s:.3f} s, {disk_train} examples, "
                  f"{disk_train / ep_s:.0f} examples/s{ft_note}; launches (K1, K1-lanes, K2) "
                  f"{got}; "
                  f"test macro AUC {auc:.6f}, weighted {wauc:.6f}, loss {loss:.6f}; weights "
                  f"moved{'; meta moved on masked leaves only, frozen tables the same tensors' if hasattr(strat, 'meta') else ''}; {card}")
            del trainer, strat, params0, start
    finally:
        for k, v in originals.items():
            setattr(fused, k, v)

    # A small input against the reference: each run() on the card against the
    # same run() on the CPU through the plain versions (one batch a domain,
    # dropout off, 3 epochs).
    def small_strategy_run(name, device):
        cfg = ExperimentConfig.from_dict({
            "model": {"name": name, "user_dim": 8, "item_dim": 8, "domain_dim": 8,
                      "hidden_dim": [32, 16], "dropout": 0.0},
            "train": {"load_pretrain_emb": True, "emb_trainable": False, "epoch": 3,
                      "patience": 2, "learning_rate": 1e-2, "meta_learning_rate": 0.1,
                      "checkpoint_path": os.path.join(work, "small", str(device))},
            "dataset": {"name": "synthetic", "batch_size": 64, "seed": 21}})
        small = make_synthetic_dataset(n_domain=3, n_uid=50, n_pid=60, n_per_domain=100,
                                       seed=21, long_tail=True, batch_size=64)
        r = np.random.default_rng(0)
        small.user_emb = r.normal(0, 0.1, (50, 8)).astype(np.float32)
        small.item_emb = r.normal(0, 0.1, (60, 8)).astype(np.float32)
        return build_strategy(Trainer(cfg, small, device=device, verbose=False)).run()

    for name in new_counts:
        on_card, on_cpu = small_strategy_run(name, None), small_strategy_run(name, "cpu")
        loss_rel = max(abs(on_card[2][k] - v) / abs(v) for k, v in on_cpu[2].items())
        auc_abs = max(abs(on_card[3][k] - v) for k, v in on_cpu[3].items())
        if not (loss_rel <= 1e-3 and auc_abs <= 1e-3):
            fail(f"small {name} run() on the card vs the CPU: test losses {on_card[2]} vs "
                 f"{on_cpu[2]}, AUCs {on_card[3]} vs {on_cpu[3]}")
        print(f"small {name} run() (3 domains, 3 epochs) on the card vs the CPU's plain "
              f"versions: test loss within {loss_rel:.2e} (tol 1e-3 relative), AUC within "
              f"{auc_abs:.2e} (tol 1e-3)")

    # ---- 5e. MAML, MLDG, PCGrad and uncertainty weighting ----
    # One accumulate step (K2, then K1 at dropout rate 0 under the 0.5-dropout
    # model, the gradient tree; no optimizer) through the kernels against the
    # same step through the plain versions; then each name's run() at bench
    # shapes on the loaded data with the corpus's train values for its name
    # (workload.bench_config), every path driven with the launch counts at 0
    # just before it and read just after; and a small run() of each on the
    # card against the CPU.
    from mamdr_tpu_torch.train.steps import make_accum_grad_fn

    trainer = build_bench_trainer("mlp_meta_maml_finetune",
                                  checkpoint_path=os.path.join(work, "accum"), dataset=disk)
    strat = build_strategy(trainer)
    accum_cols = {k: v[3, :batch].contiguous() for k, v in trainer.train_block()[0].items()}

    def build_accum(tower, gather):
        grad_fn = make_accum_grad_fn(trainer.model, trainer.step_cfg, loss_grad=make_fast_loss_grad(
            trainer.model, trainer.step_cfg, tower_grad=tower, gather=gather))
        return lambda params, cols: (grad_fn(params, cols), torch.zeros((), device=dev))

    def grad_leaves(g, _):
        return [x for x in trees.leaves(g) if x is not None]

    zero_counts()
    accum_grads = trainer.accum_grad_fn(trainer.state.params, accum_cols)
    if counts() != (1, 0, 1):
        fail(f"one accumulate step launched (K1, K1-lanes, K2) {counts()}, expected (1, 0, 1)")
    frozen_grads = [n for n, g in trees.leaves_with_names(accum_grads) if g is None]
    if (frozen_grads != ["model/embedding/item_emb", "model/embedding/user_emb"]
            or not all(bool(torch.isfinite(g).all()) for g in grad_leaves(accum_grads, None))):
        fail(f"accumulate step: gradients None at {frozen_grads} or not finite")
    _, _, _, accum_err, accum_flips, accum_note, seen = hold_step(
        build_accum, fused_tower_grad, tower_grad_reference, trainer.state.params, accum_cols,
        measure=grad_leaves)
    if seen[6] != 0.0 or trainer.model.dropout != 0.5:
        fail(f"the accumulate step ran K1 at rate {seen[6]} under dropout "
             f"{trainer.model.dropout}, expected rate 0 under 0.5")
    k1a = k1_vs_plain(fused_tower_grad, tower_grad_reference, *seen, K1_REL_TOL)
    k1a_ms = device_ms(lambda: fused_tower_grad(*seen))
    k1a_plain_ms = device_ms(lambda: tower_grad_reference(*seen))
    print(f"accumulate step (K2, K1 at rate 0 under the 0.5-dropout model, the gradient tree; "
          f"no optimizer), kernels vs plain versions: largest difference in the gradients "
          f"{accum_err:.2e} of the tensor's max (tol {K1_REL_TOL}); {accum_note}; frozen "
          f"tables without a gradient; K1 at rate 0 on its operands: {report(k1a)}; K1 at rate "
          f"0 {k1a_ms * 1e3:.1f} us/call on the device (rate 0.5: {k1_ms * 1e3:.1f} us), plain "
          f"{k1a_plain_ms * 1e3:.1f} us; {card}")
    del trainer, strat, accum_grads, seen

    originals = {k: getattr(fused, k) for k in ("make_fused_passes", "make_fused_maml",
                                                "make_fused_pcgrad", "make_fused_separate")}
    fused.make_fused_passes = timed(originals["make_fused_passes"])
    fused.make_fused_maml = timed(originals["make_fused_maml"])
    fused.make_fused_pcgrad = timed(originals["make_fused_pcgrad"])
    fused.make_fused_separate = timed(originals["make_fused_separate"], 0)
    meta_counts = {}  # name -> (K1, K1-lanes, K2, K2 with ids [B], K2 with ids [L, B])
    try:
        for name in ("mlp_meta_maml_finetune", "mlp_meta_mldg_finetune", "mlp_pcgrad",
                     "mlp_uncertainty_weight"):
            trainer = build_bench_trainer(name, checkpoint_path=os.path.join(work, name),
                                          dataset=disk)
            strat = build_strategy(trainer)
            tc_ = trainer.config.train
            params0 = trainer.state.params
            spd_ = trainer.steps_per_domain()
            if len(set(spd_)) != 1:
                fail("the bench workload's domains are no longer balanced")
            ev = max(trainer.eval_steps_per_domain("val"))
            te = max(trainer.eval_steps_per_domain("test"))
            ln = max(spd_)
            if name == "mlp_pcgrad":
                # the query's steps, then sample_num aux domains' whole epochs
                k = min(tc_.sample_num, n_domain - 1)
                k1_want, rows = sum(spd_) * (1 + k), disk_train * (1 + k)
            elif name == "mlp_uncertainty_weight":
                k1_want, rows = 0, disk_train  # autograd: K2 only, one gather a step
            else:
                # support (MAML: train steps; MLDG: accumulate) + query accumulate
                k1_want, rows = 0, disk_train
                for s in disk.train:
                    n_sup = max(1, int(s.n * tc_.meta_split_ratio))
                    k1_want += -(-n_sup // batch) + -(-(s.n - n_sup) // batch)
            k2_steps = k1_want or sum(spd_)
            ft = strat.spec.finetune
            want = (k1_want, ln if ft else 0, k2_steps + ev + te + ((ln + ev + te) if ft else 0))
            epoch_s_of.clear()
            zero_counts()
            t0 = time.perf_counter()
            res = strat.run()
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            got = counts()
            if got != want:
                fail(f"{name}: run() launched (K1, K1-lanes, K2) {got}, expected {want}")
            split = k2_split()
            if split != (k2_steps, want[2] - k2_steps):
                fail(f"{name}: K2 launched {split} times with ids [B] and [L, B], expected "
                     f"{(k2_steps, want[2] - k2_steps)}")
            meta_counts[name] = (*got, *split)
            auc, wauc, loss = checked(res, "test", f"{name} run()")
            best = trainer.best_params
            start = params0["model"]["dnn"]["Dense_0"]["Dense_0"]["kernel"]
            moved = best["model"]["dnn"]["Dense_0"]["Dense_0"]["kernel"]
            if not bool(torch.isfinite(moved).all()) or torch.equal(moved, start):
                fail(f"{name}: the trained weights are not finite or did not move")
            # (the finetune stage reloads the params from the checkpoint file)
            kept = [(best, "best params")] + ([] if ft else [(trainer.state.params, "params")])
            for tree, what in kept + ([(strat.meta, "meta")] if hasattr(strat, "meta") else []):
                for (n, x), x0 in zip(trees.leaves_with_names(tree), trees.leaves(params0)):
                    if ("user_emb" in n or "item_emb" in n) and x is not x0:
                        fail(f"{name}: {what}' frozen table {n} is not the same tensor")
            note = ""
            if hasattr(strat, "meta"):
                for (n, m), a, b in zip(trees.leaves_with_names(strat.mask),
                                        trees.leaves(strat.meta), trees.leaves(params0)):
                    if m and (torch.equal(a, b) or not bool(torch.isfinite(a).all())):
                        fail(f"{name}: meta leaf {n} did not move or is not finite")
                    if not m and a is not b:
                        fail(f"{name}: meta's unmasked leaf {n} is not the same tensor")
                note = "; meta moved on masked leaves only"
            if name == "mlp_uncertainty_weight":
                lv, lv0 = best["uncertainty"]["log_vars"], params0["uncertainty"]["log_vars"]
                if not bool(torch.isfinite(lv).all()) or bool((lv == lv0).any()):
                    fail(f"{name}: log_vars did not move in every domain: {lv.flatten()}")
                note = (f"; log_vars moved in every domain (now {float(lv.min()):.6f}-"
                        f"{float(lv.max()):.6f} from 1)")
            if len(epoch_s_of) != 1 + ft:
                fail(f"{name}: {len(epoch_s_of)} epochs timed, expected {1 + ft}")
            ep_s = epoch_s_of[0]
            ft_note = f"; its finetune epoch {epoch_s_of[1]:.3f} s" if ft else ""
            hyper = (f"meta lr {tc_.meta_learning_rate}, lr {tc_.learning_rate}, "
                     f"{tc_.meta_split}"
                     f"{f' {tc_.meta_split_ratio}' if tc_.meta_split != 'train-train' else ''}"
                     if hasattr(strat, "meta_tx") else f"lr {tc_.learning_rate}")
            print(f"{name} run() at bench shapes on the loaded data (an epoch, validation, best "
                  f"checkpoint, test{', finetune' if ft else ''}; {hyper}): "
                  f"{run_s:.3f} s; its train epoch {ep_s:.3f} s, {rows} example gradients, "
                  f"{rows / ep_s:.0f} examples/s ({disk_train / ep_s:.0f} train rows/s)"
                  f"{ft_note}; launches (K1, K1-lanes, K2) {got}; test macro AUC {auc:.6f}, "
                  f"weighted {wauc:.6f}, loss {loss:.6f}; weights moved, frozen tables the "
                  f"same tensors{note}; {card}")
            del trainer, strat, params0, start, best, moved
    finally:
        for k, v in originals.items():
            setattr(fused, k, v)

    def small_meta_run(name, device):
        split = {"mlp_meta_maml_finetune": {"meta_split": "meta-train/val",
                                            "meta_split_ratio": 0.2},
                 "mlp_meta_mldg_finetune": {"meta_split": "meta-train/val",
                                            "meta_split_ratio": 0.8}}.get(name, {})
        cfg = ExperimentConfig.from_dict({
            "model": {"name": name, "user_dim": 8, "item_dim": 8, "domain_dim": 8,
                      "hidden_dim": [32, 16], "dropout": 0.0},
            "train": {"load_pretrain_emb": True, "emb_trainable": False, "epoch": 3,
                      "patience": 2, "learning_rate": 1e-2, "meta_learning_rate": 1e-2,
                      "sample_num": 2, **split,
                      "checkpoint_path": os.path.join(work, "small_meta", str(device))},
            "dataset": {"name": "synthetic", "batch_size": 64, "seed": 21}})
        small = make_synthetic_dataset(n_domain=3, n_uid=50, n_pid=60, n_per_domain=100,
                                       seed=21, long_tail=True, batch_size=64)
        r = np.random.default_rng(0)
        small.user_emb = r.normal(0, 0.1, (50, 8)).astype(np.float32)
        small.item_emb = r.normal(0, 0.1, (60, 8)).astype(np.float32)
        return build_strategy(Trainer(cfg, small, device=device, verbose=False)).run()

    for name in meta_counts:
        on_card, on_cpu = small_meta_run(name, None), small_meta_run(name, "cpu")
        loss_rel = max(abs(on_card[2][k] - v) / abs(v) for k, v in on_cpu[2].items())
        auc_abs = max(abs(on_card[3][k] - v) for k, v in on_cpu[3].items())
        if not (loss_rel <= 1e-3 and auc_abs <= 1e-3):
            fail(f"small {name} run() on the card vs the CPU: test losses {on_card[2]} vs "
                 f"{on_cpu[2]}, AUCs {on_card[3]} vs {on_cpu[3]}")
        print(f"small {name} run() (3 domains, 3 epochs) on the card vs the CPU's plain "
              f"versions: test loss within {loss_rel:.2e} (tol 1e-3 relative), AUC within "
              f"{auc_abs:.2e} (tol 1e-3)")

    # ---- 5f. the rest of the zoo: nine base models and MAMDR on two of them ----
    # One autograd lane step of each of the nine at the DR lane-step's shape
    # (30 lanes x 1024 ids, every lane its own weights and domain, the domain
    # table lane-stacked) through K2 against the same step through K2's plain
    # version; then each joint name's run() and MAMDR's on DeepFM and MMoE at
    # bench shapes on the loaded data (the corpus's Taobao_30 model block and
    # train values per name, epoch 1), every path driven with the launch
    # counts at 0 just before it and read just after; and a small run() of
    # each on the card against the CPU.
    from mamdr_tpu_torch.train.steps import make_autograd_loss_grad
    from mamdr_tpu_torch.workload import ZOO_MAMDR_MODELS, ZOO_MODELS

    zoo_lane = {}  # name -> the lane step's largest difference, K2 vs its plain version
    for name in ZOO_MODELS:
        trainer = build_bench_trainer(name, checkpoint_path=os.path.join(work, "lane_" + name),
                                      dataset=disk)
        model, cfg_ = trainer.model, trainer.step_cfg
        frozen = trees.named_tree_map(lambda n, x: "user_emb" in n or "item_emb" in n,
                                      trainer.state.params)
        params = trees.tree_map(  # lane l: every trainable leaf scaled by 1 + l / 100
            lambda f, x: x if f else torch.stack([x * (1.0 + 0.01 * l) for l in range(lanes)]),
            frozen, trainer.state.params)
        lane_cols = {k: v[:, :batch].contiguous() for k, v in trainer.train_block()[0].items()}
        seeds_ = torch.randint(0, 2**32, (lanes, model.n_dropout_sites), device=dev,
                               generator=torch.Generator(device=dev).manual_seed(7))
        k2_before = gather_fields.launches
        data_k, g_k = make_autograd_loss_grad(model, cfg_)(params, lane_cols, seeds_)
        if gather_fields.launches != k2_before + 1:
            fail(f"{name}: the autograd lane step launched K2 "
                 f"{gather_fields.launches - k2_before}x, expected once")
        data_p, g_p = make_autograd_loss_grad(model, cfg_, gather=gather_fields_reference)(
            params, lane_cols, seeds_)
        names_g = [n for n, g in trees.leaves_with_names(g_k) if g is not None]
        if [n for n, g in trees.leaves_with_names(g_k) if g is None] != [
                n for n, f in trees.leaves_with_names(frozen) if f]:
            fail(f"{name}: the lane step's gradients are None off the frozen tables")
        got_ = [data_k] + [g for g in trees.leaves(g_k) if g is not None]
        want_ = [data_p] + [g for g in trees.leaves(g_p) if g is not None]
        if not all(bool(torch.isfinite(g).all()) for g in got_):
            fail(f"{name}: the lane step's losses or gradients are not finite")
        _, lane_rel = worst_errors(got_, want_)
        dom_g = g_k["model"]["embedding"]["domain_emb"]
        own = torch.arange(lanes, device=dev)  # lane l's batch is domain l's
        if (dom_g.shape != (lanes, n_domain, 128)
                or not bool(dom_g[own, own].abs().sum(-1).gt(0).all())):
            fail(f"{name}: the domain table's lane gradient has shape {tuple(dom_g.shape)} "
                 "or no lane's own row moved")
        if not lane_rel <= K1_REL_TOL:
            fail(f"{name}: the autograd lane step through K2 and through its plain version "
                 f"differ by {lane_rel} of a tensor's max")
        zoo_lane[name] = lane_rel
        print(f"{name}: one autograd lane step ({lanes} lanes x {batch} ids, every lane its "
              f"own weights, dropout {model.dropout}), K2 vs its plain version: "
              f"{len(names_g)} gradients (the [{lanes}, {n_domain}, 128] domain table's among "
              f"them) and {lanes} losses within {lane_rel:.2e} of the tensor's max (tol "
              f"{K1_REL_TOL}); frozen tables without a gradient")
        del trainer, model, params, g_k, g_p, got_, want_, dom_g
        torch.cuda.empty_cache()

    originals = {k: getattr(fused, k) for k in ("make_fused_passes", "make_fused_separate")}
    fused.make_fused_passes = timed(originals["make_fused_passes"])
    fused.make_fused_separate = timed(originals["make_fused_separate"], 0)
    zoo_counts = {}  # name -> (K1, K1-lanes, K2, K2 with ids [B], K2 with ids [L, B])
    try:
        for name in ZOO_MODELS + ZOO_MAMDR_MODELS:
            trainer = build_bench_trainer(name, checkpoint_path=os.path.join(work, name),
                                          dataset=disk)
            strat = build_strategy(trainer)
            tc_ = trainer.config.train
            params0 = trainer.state.params
            spd_ = trainer.steps_per_domain()
            ev = max(trainer.eval_steps_per_domain("val"))
            te = max(trainer.eval_steps_per_domain("test"))
            ln = max(spd_)
            ft = strat.spec.finetune
            mamdr = isinstance(strat, MAMDRStrategy)
            k2_steps = sum(spd_)  # one field gather a step
            dr_steps = 0
            if mamdr:  # K support runs, each a support epoch and a query epoch of lanes
                k = min(tc_.sample_num, n_domain - 1) + int(tc_.add_query_domain)
                dr_steps = k * 2 * ln
                spec0 = list(strat.specific)
                run_epoch = strat.run_fused_epoch

                def timed_epoch():
                    torch.cuda.synchronize()
                    t0_ = time.perf_counter()
                    r = run_epoch()
                    torch.cuda.synchronize()
                    epoch_s_of.append(time.perf_counter() - t0_)
                    return r

                strat.run_fused_epoch = timed_epoch
            want = (0, 0, k2_steps + dr_steps + ev + te + ((ln + ev + te) if ft else 0))
            epoch_s_of.clear()
            zero_counts()
            t0 = time.perf_counter()
            res = strat.run()
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            got = counts()
            if got != want:
                fail(f"{name}: run() launched (K1, K1-lanes, K2) {got}, expected {want}")
            split = k2_split()
            if split != (k2_steps, want[2] - k2_steps):
                fail(f"{name}: K2 launched {split} times with ids [B] and [L, B], expected "
                     f"{(k2_steps, want[2] - k2_steps)}")
            zoo_counts[name] = (*got, *split)
            auc, wauc, loss = checked(res, "test", f"{name} run()")
            best = trainer.best_params
            moved_ = [n for (n, x), x0 in zip(trees.leaves_with_names(best),
                                               trees.leaves(params0))
                      if not torch.equal(x, x0)]
            tower_moved = [n for n in moved_ if "emb" not in n]
            if "model/embedding/domain_emb" not in moved_ or not tower_moved:
                fail(f"{name}: the trained weights did not move ({moved_})")
            if not all(bool(torch.isfinite(x).all()) for x in trees.leaves(best)):
                fail(f"{name}: the trained weights are not finite")
            for tree, what in [(best, "best params")] + ([] if ft else [(trainer.state.params,
                                                                         "params")]):
                for (n, x), x0 in zip(trees.leaves_with_names(tree), trees.leaves(params0)):
                    if ("user_emb" in n or "item_emb" in n) and x is not x0:
                        fail(f"{name}: {what}' frozen table {n} is not the same tensor")
            note = ""
            if mamdr:
                if not strat.dr_lanes:
                    fail(f"{name}: the DR phase did not take the lanes")
                for d in range(n_domain):
                    leaves_d = [(a, b) for m, a, b in zip(trees.leaves(strat.mask),
                                                          trees.leaves(strat.specific[d]),
                                                          trees.leaves(spec0[d])) if m]
                    if (not any(not torch.equal(a, b) for a, b in leaves_d)
                            or not all(bool(torch.isfinite(a).all()) for a, _ in leaves_d)):
                        fail(f"{name}: specific[{d}] did not move or is not finite")
                note = (f"; DR as {n_domain} lanes ({dr_steps} autograd lane-steps), every "
                        f"domain's specific moved and finite")
            if len(epoch_s_of) != 1 + ft:
                fail(f"{name}: {len(epoch_s_of)} epochs timed, expected {1 + ft}")
            ep_s = epoch_s_of[0]
            rows = epoch_examples if mamdr else disk_train
            ft_note = f"; its finetune epoch {epoch_s_of[1]:.3f} s" if ft else ""
            print(f"{name} run() at bench shapes on the loaded data (an epoch, validation, "
                  f"best checkpoint, test{', finetune' if ft else ''}; lr {tc_.learning_rate}, "
                  f"hidden {list(trainer.config.model.hidden_dim)}, dropout "
                  f"{trainer.model.dropout}): {run_s:.3f} s; its train epoch {ep_s:.3f} s, "
                  f"{rows} examples, {rows / ep_s:.0f} examples/s{ft_note}; launches (K1, "
                  f"K1-lanes, K2) {got}; test macro AUC {auc:.6f}, weighted {wauc:.6f}, loss "
                  f"{loss:.6f}; weights moved, frozen tables (the linear ones too) the same "
                  f"tensors{note}; {card}")
            del trainer, strat, params0, best
            torch.cuda.empty_cache()
    finally:
        for k, v in originals.items():
            setattr(fused, k, v)

    def small_zoo_run(name, device):
        cfg = ExperimentConfig.from_dict({
            "model": {"name": name, "user_dim": 8, "item_dim": 8, "domain_dim": 8,
                      "hidden_dim": [16, 8], "dropout": 0.0, "tower_hidden_dim": [8],
                      "num_experts": 3, "gate_dnn_hidden_units": [8],
                      "specific_expert_num": 2, "shared_expert_num": 1, "num_levels": 1},
            "train": {"load_pretrain_emb": True, "emb_trainable": False, "epoch": 3,
                      "patience": 2, "learning_rate": 1e-2, "meta_learning_rate": 0.1,
                      "sample_num": 2,
                      "checkpoint_path": os.path.join(work, "small_zoo", str(device))},
            "dataset": {"name": "synthetic", "batch_size": 64, "seed": 21}})
        small = make_synthetic_dataset(n_domain=3, n_uid=50, n_pid=60, n_per_domain=100,
                                       seed=21, long_tail=True, batch_size=64)
        r = np.random.default_rng(0)
        small.user_emb = r.normal(0, 0.1, (50, 8)).astype(np.float32)
        small.item_emb = r.normal(0, 0.1, (60, 8)).astype(np.float32)
        return build_strategy(Trainer(cfg, small, device=device, verbose=False)).run()

    for name in zoo_counts:
        on_card, on_cpu = small_zoo_run(name, None), small_zoo_run(name, "cpu")
        loss_rel = max(abs(on_card[2][k] - v) / abs(v) for k, v in on_cpu[2].items())
        auc_abs = max(abs(on_card[3][k] - v) for k, v in on_cpu[3].items())
        if not (loss_rel <= 1e-3 and auc_abs <= 1e-3):
            fail(f"small {name} run() on the card vs the CPU: test losses {on_card[2]} vs "
                 f"{on_cpu[2]}, AUCs {on_card[3]} vs {on_cpu[3]}")
        print(f"small {name} run() (3 domains, 3 epochs) on the card vs the CPU's plain "
              f"versions: test loss within {loss_rel:.2e} (tol 1e-3 relative), AUC within "
              f"{auc_abs:.2e} (tol 1e-3)")

    # ---- 5g. STAR: per-domain batch statistics on K2 and autograd ----
    # One autograd train step and one finetune lane-step through K2 against
    # the same through K2's plain version; then star's and
    # star_meta_mamdr_finetune's run() at bench shapes on the loaded data
    # (every path driven with the launch counts at 0 just before it and read
    # just after); and a small run() of each on the card against the CPU.
    from mamdr_tpu_torch.workload import STAR_MODELS

    trainer = build_bench_trainer("star_meta_mamdr_finetune",
                                  checkpoint_path=os.path.join(work, "star_step"), dataset=disk)
    model, cfg_ = trainer.model, trainer.step_cfg
    stats0 = trainer.state.batch_stats
    step_cols = {k: v[0, :batch] for k, v in trainer.train_block()[0].items()}  # domain 0
    k2_before = gather_fields.launches
    out_k = make_autograd_loss_grad(model, cfg_)(trainer.state.params, step_cols, None,
                                                 stats=stats0)
    if gather_fields.launches != k2_before + 1:
        fail(f"STAR's autograd step launched K2 {gather_fields.launches - k2_before}x")
    out_p = make_autograd_loss_grad(model, cfg_, gather=gather_fields_reference)(
        trainer.state.params, step_cols, None, stats=stats0)
    # The domain table's gradient is held to the step's largest gradient: the
    # norm's backward cancels the rows' terms on the domain columns (constant
    # in a one-domain batch), leaving its l2 term and the rounding of a sum
    # that K2's scatter-add takes in another order
    flat_out = lambda o: [o[0]] + [g for n, g in trees.leaves_with_names(o[1])
                                   if g is not None and n != "model/domain_emb"] + trees.leaves(
        o[2])
    got_, want_ = flat_out(out_k), flat_out(out_p)
    dom_k, dom_p = out_k[1]["model"]["domain_emb"], out_p[1]["model"]["domain_emb"]
    if not all(bool(torch.isfinite(g).all()) for g in got_ + [dom_k]):
        fail("STAR's autograd step: a loss, gradient or statistic is not finite")
    star_step_abs, star_step_rel = worst_errors(got_, want_)
    dom_rel = float((dom_k - dom_p).abs().max()) / max(
        float(g.abs().max()) for g in trees.leaves(out_p[1]) if g is not None)
    if not (star_step_rel <= K1_REL_TOL and dom_rel <= K1_REL_TOL):
        fail(f"STAR's autograd step through K2 and through its plain version differ by "
             f"{star_step_rel} of a tensor's max, the domain table's gradient by {dom_rel} "
             "of the step's largest gradient")
    new_state, _ = trainer.train_step_fn()(trainer.state, step_cols)
    for key in ("moving_mean", "moving_var"):
        now = new_state.batch_stats["partitioned_norm"][key]
        was = stats0["partitioned_norm"][key]
        if not torch.equal(now[1:], was[1:]) or torch.equal(now[0], was[0]):
            fail(f"STAR's train step on domain 0 did not move exactly row 0 of {key}")
    print(f"STAR autograd train step ({batch} ids, PartitionedNorm in train mode), K2 vs its "
          f"plain version: the loss, {len(got_) - 3} gradients and the 2 new statistics within "
          f"{star_step_rel:.2e} of the tensor's max, the domain table's gradient within "
          f"{dom_rel:.2e} of the step's largest (tol {K1_REL_TOL}); a step on domain 0 "
          f"moved row 0 of the [{n_domain}, 384] moving mean and variance and no other row")
    del out_k, out_p, got_, want_, new_state, dom_k, dom_p

    star_strat = build_strategy(trainer)
    ft_lanes = separate.make_lanes(trainer, init_params=False,
                                   params_fn=star_strat._best_params_fn)
    ft_cols = {k: v[:, :batch].contiguous() for k, v in ft_lanes.block.items()}
    frozen = trees.named_tree_map(lambda n, x: "user_emb" in n or "item_emb" in n,
                                  trainer.state.params)
    plain_step, _, _ = make_subset_train_step(
        model, trainer.finetune_tx, cfg_, frozen, trainer.state.params,
        loss_grad=make_autograd_loss_grad(model, cfg_, gather=gather_fields_reference))
    kernel_step, _, _ = make_subset_train_step(model, trainer.finetune_tx, cfg_, frozen,
                                               trainer.state.params)
    k2_before = gather_fields.lane_launches
    lane_k, loss_lk = kernel_step(ft_lanes.states, ft_cols)
    if gather_fields.lane_launches != k2_before + 1:
        fail(f"STAR's finetune lane-step launched K2 {gather_fields.lane_launches - k2_before}x")
    lane_p, loss_lp = plain_step(ft_lanes.states, ft_cols)
    flat_state = lambda st, loss: [loss] + [x for x in trees.leaves(st.params) if x.dim() > 0] + (
        trees.leaves(st.batch_stats))
    got_, want_ = flat_state(lane_k, loss_lk), flat_state(lane_p, loss_lp)
    star_lane_abs, star_lane_rel = worst_errors(got_, want_)
    mm_lanes = lane_k.batch_stats["partitioned_norm"]["moving_mean"]
    if (not all(bool(torch.isfinite(g).all()) for g in got_)
            or tuple(mm_lanes.shape) != (lanes, n_domain, 384)
            or not star_lane_rel <= K1_REL_TOL):
        fail(f"STAR's finetune lane-step through K2 vs its plain version: "
             f"{star_lane_rel} of a tensor's max, statistics {tuple(mm_lanes.shape)}")
    print(f"STAR finetune lane-step ({lanes} domain lanes x {batch} ids, SGD, statistics "
          f"[{lanes}, {n_domain}, 384] lane-stacked), K2 vs its plain version: the new "
          f"params, statistics and losses within {star_lane_rel:.2e} of the tensor's max "
          f"(tol {K1_REL_TOL})")
    del trainer, star_strat, ft_lanes, lane_k, lane_p, got_, want_, model
    torch.cuda.empty_cache()

    originals = {k: getattr(fused, k) for k in ("make_fused_passes", "make_fused_separate")}
    fused.make_fused_passes = timed(originals["make_fused_passes"])
    fused.make_fused_separate = timed(originals["make_fused_separate"], 0)
    star_counts = {}  # name -> (K1, K1-lanes, K2, K2 with ids [B], K2 with ids [L, B])
    try:
        for name in STAR_MODELS:
            trainer = build_bench_trainer(name, checkpoint_path=os.path.join(work, name),
                                          dataset=disk)
            strat = build_strategy(trainer)
            tc_ = trainer.config.train
            params0, stats0 = trainer.state.params, trainer.state.batch_stats
            spd_ = trainer.steps_per_domain()
            ev = max(trainer.eval_steps_per_domain("val"))
            te = max(trainer.eval_steps_per_domain("test"))
            ft = strat.spec.finetune
            mamdr = isinstance(strat, MAMDRStrategy)
            k2_steps = sum(spd_)  # one field gather a step
            phase_s = {}
            if mamdr:  # sequential DR: per query, K support runs of a support and a query
                # epoch (the bench data is balanced: every domain the same steps)
                k = min(tc_.sample_num, n_domain - 1) + int(tc_.add_query_domain)
                k2_steps += n_domain * k * 2 * max(spd_)
                spec0 = list(strat.specific)
                run_epoch, run_dr = strat.run_fused_epoch, strat.run_dr_phase

                def timed_dr():
                    torch.cuda.synchronize()
                    phase_s["dn"] = time.perf_counter() - phase_s.pop("start")
                    t0_ = time.perf_counter()
                    run_dr()
                    torch.cuda.synchronize()
                    phase_s["dr"] = time.perf_counter() - t0_

                def timed_epoch():
                    torch.cuda.synchronize()
                    t0_ = phase_s["start"] = time.perf_counter()
                    r = run_epoch()
                    torch.cuda.synchronize()
                    epoch_s_of.append(time.perf_counter() - t0_)
                    return r

                strat.run_fused_epoch, strat.run_dr_phase = timed_epoch, timed_dr
            want = (0, 0, k2_steps + ev + te + ((max(spd_) + ev + te) if ft else 0))
            epoch_s_of.clear()
            zero_counts()
            t0 = time.perf_counter()
            res = strat.run()
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            got = counts()
            if got != want:
                fail(f"{name}: run() launched (K1, K1-lanes, K2) {got}, expected {want}")
            split = k2_split()
            if split != (k2_steps, want[2] - k2_steps):
                fail(f"{name}: K2 launched {split} times with ids [B] and [L, B], expected "
                     f"{(k2_steps, want[2] - k2_steps)}")
            star_counts[name] = (*got, *split)
            auc, wauc, loss = checked(res, "test", f"{name} run()")
            best = trainer.best_params
            moved_ = [n for (n, x), x0 in zip(trees.leaves_with_names(best),
                                               trees.leaves(params0)) if not torch.equal(x, x0)]
            if ("model/domain_emb" not in moved_
                    or not any("star_fcn" in n for n in moved_)
                    or not all(bool(torch.isfinite(x).all()) for x in trees.leaves(best))):
                fail(f"{name}: the trained weights did not move or are not finite ({moved_})")
            for (n, x), x0 in zip(trees.leaves_with_names(best), trees.leaves(params0)):
                if ("user_emb" in n or "item_emb" in n) and x is not x0:
                    fail(f"{name}: the best params' frozen table {n} is not the same tensor")
            for (n, x), x0 in zip(trees.leaves_with_names(trainer.state.batch_stats),
                                  trees.leaves(stats0)):
                # every domain trained, so every domain's row moved
                if (not bool(torch.isfinite(x).all())
                        or not bool((x != x0).any(dim=-1).all())):
                    fail(f"{name}: a domain's row of the statistics {n} did not move or is "
                         "not finite")
            note = ""
            if mamdr:
                if strat.dr_lanes:
                    fail(f"{name}: the DR phase took the lanes with batch statistics")
                for d in range(n_domain):
                    leaves_d = [(a, b) for m, a, b in zip(trees.leaves(strat.mask),
                                                          trees.leaves(strat.specific[d]),
                                                          trees.leaves(spec0[d])) if m]
                    if (not any(not torch.equal(a, b) for a, b in leaves_d)
                            or not all(bool(torch.isfinite(a).all()) for a, _ in leaves_d)):
                        fail(f"{name}: specific[{d}] did not move or is not finite")
                dr_n = k2_steps - sum(spd_)
                note = (f"; DN {phase_s['dn']:.3f} s; DR sequential ({dr_n} autograd steps) "
                        f"{phase_s['dr']:.3f} s, {phase_s['dr'] / dr_n * 1e6:.1f} us/step; "
                        f"every domain's specific moved and finite")
            if len(epoch_s_of) != 1 + ft:
                fail(f"{name}: {len(epoch_s_of)} epochs timed, expected {1 + ft}")
            ep_s = epoch_s_of[0]
            rows = epoch_examples if mamdr else disk_train
            ft_note = f"; its finetune epoch {epoch_s_of[1]:.3f} s" if ft else ""
            print(f"{name} run() at bench shapes on the loaded data (an epoch, validation, "
                  f"best checkpoint, test{', finetune' if ft else ''}; lr {tc_.learning_rate}, "
                  f"norm {trainer.config.model.norm}, dense {trainer.config.model.dense}, "
                  f"meta_parms {tc_.meta_parms}): {run_s:.3f} s; its train epoch {ep_s:.3f} s, "
                  f"{rows} examples, {rows / ep_s:.0f} examples/s{ft_note}; launches (K1, "
                  f"K1-lanes, K2) {got}, K2 split {split}; test macro AUC {auc:.6f}, weighted "
                  f"{wauc:.6f}, loss {loss:.6f}; weights and every domain's statistics row "
                  f"moved, frozen tables the same tensors{note}; {card}")
            del trainer, strat, params0, stats0, best
            torch.cuda.empty_cache()
    finally:
        for k, v in originals.items():
            setattr(fused, k, v)

    def small_star_run(name, device):
        # MAMDR's inner optimizer is SGD here: PartitionedNorm makes the
        # domain columns' gradients rounding noise (constant in a one-domain
        # batch), which Adam would scale up differently on the two devices
        inner = {"optimizer": "sgd", "learning_rate": 0.1} if "mamdr" in name else {
            "learning_rate": 1e-2}
        cfg = ExperimentConfig.from_dict({
            "model": {"name": name, "user_dim": 8, "item_dim": 8, "domain_dim": 8,
                      "hidden_dim": [16, 8], "auxiliary_dim": 8, "norm": "pn",
                      "dense": "star"},
            "train": {"load_pretrain_emb": True, "emb_trainable": False, "epoch": 3,
                      "patience": 2, "meta_learning_rate": 0.1, "sample_num": 2,
                      "meta_parms": ["emb", "kernel_shared", "bias_shared"], **inner,
                      "checkpoint_path": os.path.join(work, "small_star", str(device))},
            "dataset": {"name": "synthetic", "batch_size": 64, "seed": 21}})
        small = make_synthetic_dataset(n_domain=3, n_uid=50, n_pid=60, n_per_domain=100,
                                       seed=21, long_tail=True, batch_size=64)
        r = np.random.default_rng(0)
        small.user_emb = r.normal(0, 0.1, (50, 8)).astype(np.float32)
        small.item_emb = r.normal(0, 0.1, (60, 8)).astype(np.float32)
        return build_strategy(Trainer(cfg, small, device=device, verbose=False)).run()

    for name in STAR_MODELS:
        on_card, on_cpu = small_star_run(name, None), small_star_run(name, "cpu")
        loss_rel = max(abs(on_card[2][k] - v) / abs(v) for k, v in on_cpu[2].items())
        auc_abs = max(abs(on_card[3][k] - v) for k, v in on_cpu[3].items())
        if not (loss_rel <= 1e-3 and auc_abs <= 1e-3):
            fail(f"small {name} run() on the card vs the CPU: test losses {on_card[2]} vs "
                 f"{on_cpu[2]}, AUCs {on_card[3]} vs {on_cpu[3]}")
        print(f"small {name} run() (3 domains, 3 epochs) on the card vs the CPU's plain "
              f"versions: test loss within {loss_rel:.2e} (tol 1e-3 relative), AUC within "
              f"{auc_abs:.2e} (tol 1e-3)")
    # ---- 5h. the per-call route: fit_domain / evaluate_domain and the loops on it ----
    # One per-call train step (the first batch of stack_train_epoch: K2, K1,
    # flat Adam, the gate) and one per-call accumulate step (a batch of
    # stack_split: K2, K1 at rate 0, the gradient tree) through the kernels
    # against the same steps through the plain versions; then the run() of
    # five names that take the per-call loops at bench shapes on the loaded
    # data (epoch 1, the corpus's values per name), every path driven with the
    # launch counts at 0 just before it and read just after, each timed with
    # its train epoch; and a small run() of each, and of
    # star_meta_mamdr_finetune under fixed_train, on the card against the CPU.
    from mamdr_tpu_torch.train.steps import make_accum_grad_fn

    def percall_trainer(name, fixed, **train):
        cfg = bench_config(checkpoint_path=os.path.join(work, "percall", name), model=name)
        for k, v in train.items():
            setattr(cfg.train, k, v)
        disk.fixed_train = fixed
        return Trainer(cfg, disk, verbose=False)

    trainer = percall_trainer("mlp_meta_mamdr_finetune", True)
    if trainer.fused_padding_ok(ragged=True):
        fail("fixed_train did not close the fused passes' gate")
    pc_cols = {k: v[0] for k, v in trainer.stack_train_epoch(3).items()}
    zero_counts()
    trainer.fit_domain(trainer.state, 3, max_steps=1)
    if counts() != (1, 0, 1) or k2_split() != (1, 0):
        fail(f"one per-call train step launched (K1, K1-lanes, K2) {counts()}, expected "
             "(1, 0, 1) with ids [B]")
    _, pc_lk, pc_lp, pc_step_err, _, pc_step_note, pc_seen = hold_step(
        lambda tower, gather: make_train_step(
            trainer.model, trainer.tx, trainer.step_cfg,
            loss_grad=make_fast_loss_grad(trainer.model, trainer.step_cfg,
                                          tower_grad=tower, gather=gather)),
        fused_tower_grad, tower_grad_reference, trainer.state, pc_cols)
    k1pc = k1_vs_plain(fused_tower_grad, tower_grad_reference, *pc_seen, K1_REL_TOL)
    print(f"per-call train step (a batch of stack_train_epoch under fixed_train), kernels vs "
          f"plain versions: loss {float(pc_lk):.6f} vs {float(pc_lp):.6f}, largest difference "
          f"in loss, mu, nu {pc_step_err:.2e} of the tensor's max (tol {K1_REL_TOL}); "
          f"{pc_step_note}; K1 on its operands: {report(k1pc)}")
    acc_cols = {k: v[0] for k, v in trainer.stack_split(disk.train[5], shuffle=True).items()}

    def build_pc_accum(tower, gather):
        grad_fn = make_accum_grad_fn(trainer.model, trainer.step_cfg, loss_grad=make_fast_loss_grad(
            trainer.model, trainer.step_cfg, tower_grad=tower, gather=gather))
        return lambda params, cols: (grad_fn(params, cols), torch.zeros((), device=dev))

    _, _, _, pc_acc_err, _, pc_acc_note, pc_acc_seen = hold_step(
        build_pc_accum, fused_tower_grad, tower_grad_reference, trainer.state.params, acc_cols,
        measure=lambda g, _: [x for x in trees.leaves(g) if x is not None])
    k1pa = k1_vs_plain(fused_tower_grad, tower_grad_reference, *pc_acc_seen, K1_REL_TOL)
    if pc_acc_seen[6] != 0.0:
        fail(f"the per-call accumulate step ran K1 at rate {pc_acc_seen[6]}, expected 0")
    print(f"per-call accumulate step (a batch of stack_split, shuffled), kernels vs plain "
          f"versions: largest difference in the gradients {pc_acc_err:.2e} of the tensor's "
          f"max (tol {K1_REL_TOL}); {pc_acc_note}; K1 at rate 0 on its operands: "
          f"{report(k1pa)}")
    del trainer

    cdiv = lambda a, b: -(-a // b)  # noqa: E731
    percall_runs = (
        ("mlp_meta_mamdr_finetune", True, {}, "fixed_train"),
        ("mlp_meta_mamdr_batch_finetune", False, {"finetune_every_epoch": True},
         "finetune_every_epoch"),
        ("mlp_meta_domain_negotiation_finetune", False,
         {"target_domain": 0, "meta_finetune_step": 1}, "target_domain 0, meta_finetune_step 1"),
        ("mlp_meta_maml_finetune", False, {"average_meta_grad": "drop"},
         'average_meta_grad "drop"'),
        ("mlp_pcgrad", False, {"target_domain": 0}, "target_domain 0"),
    )
    percall_counts = {}  # name -> (K1, K1-lanes, K2, K2 with ids [B], K2 with ids [L, B])
    percall_s = {}       # name -> (run s, train epoch s, host-paced steps in it)
    try:
        for name, fixed, train_kw, what in percall_runs:
            trainer = percall_trainer(name, fixed, **train_kw)
            strat = build_strategy(trainer)
            tc_ = trainer.config.train
            params0 = trainer.state.params
            spd_ = trainer.steps_per_domain()
            ln, d_ = max(spd_), n_domain
            ev = max(trainer.eval_steps_per_domain("val"))
            te = max(trainer.eval_steps_per_domain("test"))
            lanes_ft = ln + ev + te  # the finetune lanes: an epoch, val, test
            k_ = min(tc_.sample_num, d_ - 1) + int(tc_.add_query_domain)
            if isinstance(strat, MAMDRStrategy):
                if strat.use_fused:
                    fail(f"{name} ({what}) took the fused epoch")
                k1_want = sum(spd_) + d_ * k_ * 2 * ln  # DN, then DR (balanced domains)
                if tc_.finetune_every_epoch:
                    k1_want += sum(spd_)
                if fixed:  # the finetune: _separate_loop, one epoch a domain
                    k1_want += sum(spd_)
                    evals_b = sum(cdiv(s.n, batch) for s in disk.val + disk.test)
                    want = (k1_want, 0, k1_want + evals_b + ev + te)
                    split_want = (k1_want + evals_b, ev + te)
                else:
                    want = (k1_want, ln, k1_want + ev + te + lanes_ft)
            elif name == "mlp_meta_domain_negotiation_finetune":
                # 29 domains, the target appended, one more target epoch; then the
                # meta-finetune lanes (an epoch, val), test, the finetune lanes
                k1_want = sum(spd_) + spd_[0]
                want = (k1_want, 2 * ln, k1_want + ln + ev + te + lanes_ft)
            elif name == "mlp_meta_maml_finetune":
                k1_want = sum(cdiv(max(1, int(s.n * tc_.meta_split_ratio)), batch)
                              + cdiv(s.n - max(1, int(s.n * tc_.meta_split_ratio)), batch)
                              for s in disk.train)
                want = (k1_want, ln, k1_want + ev + te + lanes_ft)
            else:  # PCGrad without the target: each query, then k aux whole epochs
                k1_want = (d_ - 1) * (1 + min(tc_.sample_num, d_ - 2)) * ln
                want = (k1_want, 0, k1_want + ev + te)
            if not (isinstance(strat, MAMDRStrategy) and fixed):
                split_want = (k1_want, want[2] - k1_want)
            marks = {}
            train_fn, tail_fn = strat.train, strat.epoch_tail

            def timed_train(train_fn=train_fn):
                torch.cuda.synchronize()
                marks["start"] = time.perf_counter()
                return train_fn()

            def timed_tail(epoch, tail_fn=tail_fn):
                torch.cuda.synchronize()
                marks["epoch"] = time.perf_counter() - marks["start"]
                marks["steps"] = fused_tower_grad.launches
                return tail_fn(epoch)

            strat.train, strat.epoch_tail = timed_train, timed_tail
            spec0 = list(getattr(strat, "specific", []))
            zero_counts()
            t0 = time.perf_counter()
            res = strat.run()
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            got = counts()
            if got != want:
                fail(f"{name} ({what}): run() launched (K1, K1-lanes, K2) {got}, expected "
                     f"{want}")
            split = k2_split()
            if split != split_want:
                fail(f"{name} ({what}): K2 launched {split} times with ids [B] and [L, B], "
                     f"expected {split_want}")
            percall_counts[name] = (*got, *split)
            auc, wauc, loss = checked(res, "test", f"{name} run()")
            best = trainer.best_params
            start = params0["model"]["dnn"]["Dense_0"]["Dense_0"]["kernel"]
            moved = best["model"]["dnn"]["Dense_0"]["Dense_0"]["kernel"]
            if not bool(torch.isfinite(moved).all()) or torch.equal(moved, start):
                fail(f"{name}: the trained weights are not finite or did not move")
            for (n, x), x0 in zip(trees.leaves_with_names(best), trees.leaves(params0)):
                if ("user_emb" in n or "item_emb" in n) and x is not x0:
                    fail(f"{name}: the best params' frozen table {n} is not the same tensor")
            note = ""
            if spec0:
                for d in range(n_domain):
                    leaves_d = [(a, b) for m, a, b in zip(trees.leaves(strat.mask),
                                                          trees.leaves(strat.specific[d]),
                                                          trees.leaves(spec0[d])) if m]
                    if (not any(not torch.equal(a, b) for a, b in leaves_d)
                            or not all(bool(torch.isfinite(a).all()) for a, _ in leaves_d)):
                        fail(f"{name}: specific[{d}] did not move or is not finite")
                note = "; every domain's specific moved and finite"
            if fixed:
                frozen_shapes = [tuple(x.shape) for n, x in trees.leaves_with_names(params0)
                                 if "user_emb" in n or "item_emb" in n]
                for d in range(n_domain):
                    with np.load(os.path.join(trainer.checkpoint_dir, f"domain_{d}.npz")) as z:
                        k = z["model//dnn//Dense_0//Dense_0//kernel"]
                        tables = [z[n].shape for n in z.files if "user_emb" in n or "item_emb" in n]
                    if (not np.all(np.isfinite(k)) or tables != frozen_shapes
                            or np.array_equal(k, best["model"]["dnn"]["Dense_0"]["Dense_0"]
                                              ["kernel"].cpu().numpy())):
                        fail(f"{name}: _separate_loop's domain_{d}.npz: kernel not finite or "
                             f"not moved from the best weights, frozen tables {tables}")
                note += ("; _separate_loop finetuned every domain (domain_{d}.npz moved, "
                         "the whole best tree, frozen tables included)")
            ep_s, ep_steps = marks["epoch"], marks["steps"]
            percall_s[name] = (run_s, ep_s, ep_steps)
            print(f"{name} ({what}) run() at bench shapes on the loaded data, the per-call "
                  f"loop (an epoch, validation, best checkpoint, test"
                  f"{', finetune' if strat.spec.finetune else ''}): {run_s:.3f} s; its train "
                  f"epoch {ep_s:.3f} s, {ep_steps} host-paced steps of K1 (train and "
                  f"accumulate), {ep_s / ep_steps * 1e6:.1f} us a step, "
                  f"{disk_train / ep_s:.0f} train rows/s; launches (K1, K1-lanes, K2) {got}, "
                  f"K2 split {split}; test macro AUC {auc:.6f}, weighted {wauc:.6f}, loss "
                  f"{loss:.6f}; weights moved, frozen tables the same tensors{note}; {card}")
            del trainer, strat, params0, start, best, moved, spec0
            torch.cuda.empty_cache()
    finally:
        disk.fixed_train = False

    def small_percall_run(name, train_kw, fixed, device, star=False):
        # 2-3 batches a domain where every path is per-call (its orders come
        # from np_rng on both devices); one where a lane route runs too (the
        # lanes shuffle with the device's own generator)
        per_call_only = fixed or name == "mlp_pcgrad"
        model = ({"hidden_dim": [16, 8], "auxiliary_dim": 8, "norm": "pn", "dense": "star"}
                 if star else {"hidden_dim": [32, 16], "dropout": 0.0})
        train = {"load_pretrain_emb": True, "emb_trainable": False, "epoch": 3,
                 "patience": 2, "learning_rate": 1e-2, "sample_num": 2,
                 "meta_learning_rate": 1e-2 if "maml" in name or "pcgrad" in name else 0.1,
                 "checkpoint_path": os.path.join(work, "small_percall", name, str(device)),
                 **train_kw}
        if "maml" in name:
            train.update(meta_split="meta-train/val", meta_split_ratio=0.5)
        if star:  # SGD inner: see small_star_run
            train.update(optimizer="sgd", learning_rate=0.1,
                         meta_parms=["emb", "kernel_shared", "bias_shared"])
        cfg = ExperimentConfig.from_dict({
            "model": {"name": name, "user_dim": 8, "item_dim": 8, "domain_dim": 8, **model},
            "train": train, "dataset": {"name": "synthetic", "batch_size": 64, "seed": 21}})
        small = make_synthetic_dataset(n_domain=3, n_uid=50, n_pid=60,
                                       n_per_domain=300 if per_call_only else 100,
                                       seed=21, long_tail=True, batch_size=64)
        r = np.random.default_rng(0)
        small.user_emb = r.normal(0, 0.1, (50, 8)).astype(np.float32)
        small.item_emb = r.normal(0, 0.1, (60, 8)).astype(np.float32)
        small.fixed_train = fixed
        strat_ = build_strategy(Trainer(cfg, small, device=device, verbose=False))
        if fixed and strat_.trainer.fused_padding_ok(ragged=True):
            fail(f"small {name}: fixed_train did not close the fused passes' gate")
        return strat_.run()

    small_percall = [(name, kw, fixed, False) for name, fixed, kw, _ in percall_runs]
    small_percall.append(("star_meta_mamdr_finetune", {}, True, True))
    for name, kw, fixed, star in small_percall:
        on_card = small_percall_run(name, kw, fixed, None, star)
        on_cpu = small_percall_run(name, kw, fixed, "cpu", star)
        loss_rel = max(abs(on_card[2][k] - v) / abs(v) for k, v in on_cpu[2].items())
        auc_abs = max(abs(on_card[3][k] - v) for k, v in on_cpu[3].items())
        if not (loss_rel <= 1e-3 and auc_abs <= 1e-3):
            fail(f"small {name} run() on the card vs the CPU: test losses {on_card[2]} vs "
                 f"{on_cpu[2]}, AUCs {on_card[3]} vs {on_cpu[3]}")
        print(f"small {name} ({kw or 'fixed_train'}) run() (3 domains, 3 epochs, the "
              f"per-call loop) on the card vs the CPU's plain versions: test loss within "
              f"{loss_rel:.2e} (tol 1e-3 relative), AUC within {auc_abs:.2e} (tol 1e-3)")

    del disk
    shutil.rmtree(work, ignore_errors=True)

    # ---- 5i. resume at bench shapes ----
    # mlp_meta_mamdr_finetune at bench shapes (the in-memory bench data): (a)
    # run() of 2 epochs unbroken; (b) train() of 1 epoch with resume_every 1,
    # which writes the resume snapshot; (c) a fresh Trainer with resume and
    # epoch 2, whose run() goes on from the snapshot: it starts at epoch 1,
    # launches one epoch less than (a), and ends where (a) ends, bit for bit.
    # The three run under torch.use_deterministic_algorithms: the domain
    # table's gradient is an index_add_ of 1024 rows into one row, whose
    # atomics add in an order that varies from run to run, and on the bench's
    # random labels Adam turns those last-bit differences into differences of
    # the order of the weights themselves within an epoch. The deterministic
    # index_add_ takes them away; anything else that would not repeat is
    # printed (warn_only) and shows as a difference.
    from mamdr_tpu_torch import validate

    work_i = tempfile.mkdtemp(prefix="mamdr_chip_smoke_5i_")
    mem = bench_dataset()

    def resume_run(ckpt, epochs, **train):
        cfg = bench_config(checkpoint_path=os.path.join(work_i, ckpt))
        cfg.train.epoch = epochs
        for k, v in train.items():
            setattr(cfg.train, k, v)
        return MAMDRStrategy(Trainer(cfg, mem, verbose=False))

    def tree_rel(a_tree, b_tree):
        """Largest |a - b| over the leaves, each over its tensor's largest
        magnitude; and whether every leaf is bit-equal."""
        worst, same = 0.0, True
        for a, b in zip(trees.leaves(a_tree), trees.leaves(b_tree)):
            if a is b:
                continue
            same = same and torch.equal(a, b)
            worst = max(worst, float((a - b).abs().max() / a.abs().max().clamp_min(1e-30)))
        return worst, same

    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("default")
        strat_a = resume_run("a", 2)
        tc_i = strat_a.tc
        spd_i = strat_a.trainer.steps_per_domain()  # balanced: every domain the same
        cap_i = tc_i.domain_regulation_step
        k_i = min(tc_i.sample_num, mem.n_domain - 1) + int(tc_i.add_query_domain)
        ft_i = max(spd_i)
        ep_k1 = sum(spd_i)  # DN, then DR's support runs as lanes
        ep_k1l = k_i * (ft_i + (min(ft_i, cap_i) if cap_i > 0 else ft_i))
        val_i = max(strat_a.trainer.eval_steps_per_domain("val"))
        test_i = max(strat_a.trainer.eval_steps_per_domain("test"))
        one_epoch = (ep_k1, ep_k1l, ep_k1 + ep_k1l + val_i)
        zero_counts()
        t0 = time.perf_counter()
        res_a = strat_a.run()
        torch.cuda.synchronize()
        a_s = time.perf_counter() - t0
        a_counts = counts()
        strat_b = resume_run("bc", 1, resume_every=1)
        snap = {}
        save_b = strat_b.trainer.save_resume_state

        def timed_save(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            save_b(*a, **k)
            snap["s"] = time.perf_counter() - t

        strat_b.trainer.save_resume_state = timed_save
        strat_b.train()
        resume_dir = strat_b.trainer.resume_dir
        snap_files = {f: os.path.getsize(os.path.join(resume_dir, f))
                      for f in sorted(os.listdir(resume_dir))}
        del strat_b
        torch.cuda.empty_cache()
        strat_c = resume_run("bc", 2, resume=True)
        started = {}
        try_c = strat_c.trainer.try_resume

        def spy_resume(*a, **k):
            t = time.perf_counter()
            r = try_c(*a, **k)
            started["epoch"], started["s"] = (None if r is None else r[0]), time.perf_counter() - t
            return r

        strat_c.trainer.try_resume = spy_resume
        zero_counts()
        t0 = time.perf_counter()
        res_c = strat_c.run()
        torch.cuda.synchronize()
        c_s = time.perf_counter() - t0
        c_counts, c_split = counts(), k2_split()
    torch.use_deterministic_algorithms(False)
    not_repeatable = sorted({str(w.message).split(".")[0] for w in caught
                             if "determinis" in str(w.message)})
    ft_e = strat_c.tc.epoch  # the finetune's epochs (its lanes: an epoch and val each, then test)
    c_want = (ep_k1, ep_k1l + ft_i * ft_e,
              ep_k1 + ep_k1l + val_i + test_i + (ft_i + val_i) * ft_e + test_i)
    if started.get("epoch") != 1:
        fail(f"5i: the resumed run started at epoch {started.get('epoch')}, expected 1")
    if (c_counts != c_want or c_split != (ep_k1, c_want[2] - ep_k1)
            or tuple(a - c for a, c in zip(a_counts, c_counts)) != one_epoch):
        fail(f"5i: the resumed run() launched (K1, K1-lanes, K2) {c_counts}, K2 split "
             f"{c_split}, expected {c_want}, ({ep_k1}, {c_want[2] - ep_k1}); the unbroken "
             f"run {a_counts}, one epoch {one_epoch} more")
    diffs = {
        "shared": tree_rel(strat_a.shared, strat_c.shared),
        "specific": max((tree_rel(a, c) for a, c in zip(strat_a.specific, strat_c.specific)),
                        key=lambda r: r[0]),
        "best_shared": tree_rel(strat_a.best_shared, strat_c.best_shared),
        "best_specific": max((tree_rel(a, c) for a, c in zip(strat_a.best_specific,
                                                              strat_c.best_specific)),
                             key=lambda r: r[0]),
        "params": tree_rel(strat_a.trainer.state.params, strat_c.trainer.state.params),
    }
    auc_i = max(abs(res_a[3][k] - v) for k, v in res_c[3].items())
    loss_i = max(abs(res_a[2][k] - v) / abs(v) for k, v in res_c[2].items())
    bit_i = all(same for _, same in diffs.values()) and res_a[3] == res_c[3]
    worst_i = max(r for r, _ in diffs.values())
    if not bit_i or res_a[2] != res_c[2]:
        fail(f"5i: the resumed run is not the unbroken one bit for bit: {diffs}, test AUC by "
             f"{auc_i}, test loss by {loss_i} relative; ops without a deterministic "
             f"version: {not_repeatable}")
    resume_counts = c_counts + c_split
    snap_bytes = sum(snap_files.values())
    print(f"resume at bench shapes (mlp_meta_mamdr_finetune): (a) unbroken run() of 2 epochs "
          f"{a_s:.3f} s, launches (K1, K1-lanes, K2) {a_counts}; (b) 1 epoch wrote the snapshot "
          f"in {snap['s']:.3f} s, {snap_bytes} bytes ({json.dumps(snap_files)}); (c) resumed "
          f"from it at epoch {started['epoch']} (load {started['s']:.3f} s), run() {c_s:.3f} s, "
          f"launches {c_counts} (one epoch {one_epoch} fewer than (a)), K2 split {c_split}; "
          f"(c) against (a), deterministic algorithms on: shared, every specific, the best "
          f"snapshot, the params, the test losses and AUCs bit-equal {bit_i} (tol 0; largest "
          f"difference {worst_i:.2e}); ops reported without a deterministic version: "
          f"{not_repeatable or 'none'}; test macro AUC {res_c[1]:.6f}; {card}")
    del strat_a, strat_c

    # (d) run to run: two more unbroken run()s as (a), deterministic
    # algorithms off, held to each other; printed, not gated: how far the
    # index_add_ atomics alone move two runs of the same seed apart.
    runs_d = []
    for tag in ("d1", "d2"):
        strat_d = resume_run(tag, 2)
        runs_d.append((strat_d, strat_d.run()))
    (d1, res_d1), (d2, res_d2) = runs_d
    for res in (res_d1, res_d2):
        if not all(np.isfinite(v) for v in (*res[2].values(), *res[3].values())):
            fail(f"5i: an unbroken run (d) without deterministic algorithms ended non-finite: {res}")
    drift = {
        "shared": tree_rel(d1.shared, d2.shared)[0],
        "specific": max(tree_rel(a, b)[0] for a, b in zip(d1.specific, d2.specific)),
        "best_shared": tree_rel(d1.best_shared, d2.best_shared)[0],
        "params": tree_rel(d1.trainer.state.params, d2.trainer.state.params)[0],
    }
    auc_d = max(abs(res_d1[3][k] - v) for k, v in res_d2[3].items())
    print(f"resume at bench shapes, run to run (d): two unbroken run()s of 2 epochs with "
          f"deterministic algorithms off part by (largest |a - b| over a tensor's max) "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in drift.items()})}; test macro AUC "
          f"{res_d1[1]:.6f} / {res_d2[1]:.6f}, a domain's test AUC by up to {auc_d:.2e}; {card}")
    del runs_d, d1, d2, strat_d, mem
    shutil.rmtree(work_i, ignore_errors=True)
    torch.cuda.empty_cache()

    # ---- 5j. the model learns on the card ----
    # The Taobao-10 recipe of the JAX package's validation (a generated click
    # log whose clicks live in the space of its pretrained vectors) through the
    # port's generator and Taobao ETL, loaded by from_disk, then run() of
    # mlp_meta_mamdr_finetune with the corpus's Taobao-10 config, at most
    # LEARN_EPOCHS epochs, patience 10. Fails unless the test macro AUC reaches
    # LEARN_GATE (the JAX package's at 40 epochs: 0.7903, VALIDATION.md).
    work_j = tempfile.mkdtemp(prefix="mamdr_chip_smoke_5j_")
    t0 = time.perf_counter()
    raw_j = validate.build_raw(work_j, "taobao10")
    raw_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    validate.build_split(raw_j, work_j, "taobao10")
    etl_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds_j = validate.load(work_j, "taobao10")
    load_j_s = time.perf_counter() - t0
    rows_j = {m: sum(s.n for s in getattr(ds_j, m)) for m in ("train", "val", "test")}
    zero_counts()
    learn = validate.train_one(ds_j, "taobao10", "mlp_meta_mamdr_finetune", work_j,
                               LEARN_EPOCHS, 10)
    torch.cuda.synchronize()
    learn_counts, learn_split = counts(), k2_split()
    if not all(learn_counts) or not all(learn_split):
        fail(f"5j: a kernel of the path did not launch: (K1, K1-lanes, K2) {learn_counts}, "
             f"K2 split {learn_split}")
    if not learn["test_macro_auc"] >= LEARN_GATE:
        fail(f"5j: test macro AUC {learn['test_macro_auc']} after {learn['epochs']} epochs is "
             f"below {LEARN_GATE}: {learn}")
    learn_counts = learn_counts + learn_split
    print(f"the model learns (Taobao-10 recipe, mlp_meta_mamdr_finetune): raw log {raw_s:.3f} s, "
          f"ETL {etl_s:.3f} s, from_disk {load_j_s:.3f} s, {ds_j.n_domain} domains, rows "
          f"{rows_j}; run() {learn['seconds']:.3f} s over {learn['epochs']} epochs (cap "
          f"{LEARN_EPOCHS}); test macro AUC {learn['test_macro_auc']:.6f} (gate {LEARN_GATE}), "
          f"weighted {learn['test_weighted_auc']:.6f}; val macro AUC by epoch "
          f"{[round(v, 4) for v in learn['val_macro_auc_by_epoch']]}; launches (K1, K1-lanes, "
          f"K2) {learn_counts[:3]}, K2 split {learn_counts[3:]}; {card}")
    # K1-lanes and K2 at this path's lane shapes (10 domains: 10 lanes x 1024
    # ids, a lane-stacked [10, 10, 128] domain table), on random operands
    lanes_j = ds_j.n_domain
    per_j = [tower_inputs({1: "partial"}.get(l, "mixed")) for l in range(lanes_j)]
    args_j = (*(torch.stack([p[i] for p in per_j]) for i in range(3)),
              torch.from_numpy(rng.integers(0, 2**32, (lanes_j, len(dims) - 1),
                                            dtype=np.int64)).to(dev),
              tuple(torch.stack([p[4][i] for p in per_j]) for i in range(len(per_j[0][4]))))
    k1j = k1_vs_plain(fused_tower_grad_lanes, tower_grad_reference_lanes, *args_j, dims, 0.5,
                      K1_REL_TOL)
    k1j_ms = device_ms(lambda: fused_tower_grad_lanes(*args_j, dims, 0.5), inner=5)
    k1j_plain_ms = device_ms(lambda: tower_grad_reference_lanes(*args_j, dims, 0.5), inner=2)
    k1j_bound = lanes_j * k1_bound
    j_tables = (rand_table((ds_j.n_uid, dim)), rand_table((ds_j.n_pid, dim)),
                rand_table((lanes_j, ds_j.n_domain, dim), 1e-2))
    j_sets = [(rand_ids(ds_j.n_uid, (lanes_j, batch), False),
               rand_ids(ds_j.n_pid, (lanes_j, batch), False),
               rand_ids(ds_j.n_domain, (lanes_j, 1), False).expand(lanes_j, batch).contiguous())
              for _ in range(4)]
    x_k, _ = gather_fields(j_tables, j_sets[0], train_mask=mask)
    x_p, _ = gather_fields_reference(j_tables, j_sets[0], train_mask=mask)
    k2j_err = float((x_k - x_p).abs().max())
    if k2j_err != 0.0:
        fail(f"K2 at 5j's lane shape differs from the plain field gather: {k2j_err}")
    j_t = field_timings(j_tables, j_sets)
    j_least, j_every = field_bound(j_tables, j_sets)
    k2j_bound = j_least / HBM_BYTES * 1e3
    print(f"K1 lanes at 5j's shape ({lanes_j} lanes): {report(k1j)}; {k1j_ms * 1e3:.1f} us/call, "
          f"plain {k1j_plain_ms * 1e3:.1f} us, bound {k1j_bound * 1e3:.1f} us; {card}")
    print(timing_line(f"5j's lane-step shape ({lanes_j * batch} ids)", j_t, j_least, j_every))
    del ds_j, j_tables, j_sets, args_j, per_j, x_k, x_p
    shutil.rmtree(work_j, ignore_errors=True)
    torch.cuda.empty_cache()

    # ---- 5k. TensorBoard at bench shapes ----
    # mlp_meta_mamdr_finetune at bench shapes (the in-memory bench data) with
    # tensorboard on, histogram_freq 1 and write_grads: run() of one epoch with
    # the launch counts at 0 just before it and read just after (5c's run, and
    # the one K2 with ids [B] of _sample_grads on the val epoch, no K1 for
    # it); the event files read back with TensorBoard's EventAccumulator
    # (every val and test scalar equal to its metrics.jsonl value, one
    # histogram a parameter leaf and one grad/ histogram a leaf, each
    # counting the leaf's elements);
    # the seconds the TensorBoard work adds to run(). Then the trained
    # parameters through the Keras h5 mapping and back: bit-equal, and an
    # eval on them equal to the eval on the original tree.
    import importlib.util

    from mamdr_tpu_torch.train.steps import make_loss_grad
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    from mamdr_tpu_torch.utils import h5_import

    work_k = tempfile.mkdtemp(prefix="mamdr_chip_smoke_5k_")
    mem = bench_dataset()

    def bench_mamdr(root, tag, model=None, **train):
        """A MAMDR strategy at bench shapes on the in-memory bench data, with
        these model and train values."""
        cfg = bench_config(checkpoint_path=os.path.join(root, tag))
        for k, v in (model or {}).items():
            setattr(cfg.model, k, v)
        for k, v in train.items():
            setattr(cfg.train, k, v)
        return MAMDRStrategy(Trainer(cfg, mem, verbose=False))

    def run_counts(t, epochs, sample_grads=0):
        """(K1, K1-lanes, K2, K2 with ids [B], K2 with ids [L, B]) of a
        MAMDR run() of `epochs` epochs and its finetune, from the code's
        step counts: DN a step a domain's batch (K1 and K2), DR K support
        runs of lane-steps (K1-lanes and K2), an eval lane-step a val / test
        batch, the finetune's epochs of lane-steps and their evals, and one
        one-tower K2 a _sample_grads call."""
        spd_, tc_ = t.steps_per_domain(), t.config.train
        k_ = min(tc_.sample_num, t.dataset.n_domain - 1) + int(tc_.add_query_domain)
        ft_, cap_ = max(spd_), tc_.domain_regulation_step
        dr_ = k_ * (ft_ + (min(ft_, cap_) if cap_ > 0 else ft_))
        val_ = max(t.eval_steps_per_domain("val"))
        test_ = max(t.eval_steps_per_domain("test"))
        one_tower = epochs * sum(spd_) + sample_grads
        lane_k2 = epochs * (dr_ + val_) + test_ + (ft_ + val_) * tc_.epoch + test_
        k1 = 0 if t.model.compute_dtype != "float32" else epochs * sum(spd_)
        k1l = 0 if k1 == 0 else epochs * dr_ + ft_ * tc_.epoch
        return (k1, k1l, one_tower + lane_k2, one_tower, lane_k2)

    strat_k = bench_mamdr(work_k, "tb", tensorboard=True, histogram_freq=1, write_grads=True)
    t_k = trainer = strat_k.trainer  # checked() reads `trainer`
    tb_s = {"s": 0.0, "calls": 0}

    def timed_tb(fn):
        def wrapped(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = fn(*a, **k)
            torch.cuda.synchronize()
            tb_s["s"] += time.perf_counter() - t
            tb_s["calls"] += 1
            return r
        return wrapped

    for fn_name in ("log_eval", "log_histograms", "log_grad_histograms"):
        setattr(t_k.tb, fn_name, timed_tb(getattr(t_k.tb, fn_name)))
    t_k._sample_grads = timed_tb(t_k._sample_grads)
    want_k = run_counts(t_k, t_k.config.train.epoch, sample_grads=t_k.config.train.epoch)
    zero_counts()
    t0 = time.perf_counter()
    res_k = strat_k.run()
    torch.cuda.synchronize()
    run_k_s = time.perf_counter() - t0
    tb_counts = counts() + k2_split()
    if tb_counts != want_k:
        fail(f"5k: run() with TensorBoard launched (K1, K1-lanes, K2, K2 ids [B], K2 ids "
             f"[L, B]) {tb_counts}, expected {want_k}")
    checked(res_k, "test", "5k run()")
    tb_dir = os.path.join(t_k.checkpoint_dir, "tensorboard")
    t_k.tb.close()
    acc_k = EventAccumulator(tb_dir, size_guidance={"scalars": 0, "histograms": 0})
    acc_k.Reload()
    events_k = {
        "scalars": {tag: [(e.step, e.value) for e in acc_k.Scalars(tag)]
                    for tag in acc_k.Tags()["scalars"]},
        "histograms": {tag: [(h.step, {"num": h.histogram_value.num,
                                       "bucket": list(h.histogram_value.bucket)})
                             for h in acc_k.Histograms(tag)]
                       for tag in acc_k.Tags()["histograms"]}}
    with open(os.path.join(t_k.checkpoint_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    seen, n_scalars = {}, 0
    for rec in records:
        if not rec["event"].endswith("_eval"):
            continue
        mode = rec["event"][: -len("_eval")]
        values = {"avg_loss": rec["avg_loss"], "avg_auc": rec["avg_auc"],
                  **{f"domain_{d}_AUC": v for d, v in rec["domain_auc"].items()}}
        for key, v in values.items():
            tag = f"{mode}/{key}"
            i = seen[tag] = seen.get(tag, -1) + 1
            got = events_k["scalars"].get(tag, [])
            if len(got) <= i or got[i] != (rec["epoch"], float(np.float32(v))):
                fail(f"5k: the event files' {tag} #{i} is {got[i:i + 1]}, metrics.jsonl has "
                     f"({rec['epoch']}, {v})")
            n_scalars += 1
    n_val_k = sum(r["event"] == "val_eval" for r in records)
    leaves_k = dict(trees.leaves_with_names(t_k.state.params))
    for leaf_name, x in leaves_k.items():
        for tag in (leaf_name, f"grad/{leaf_name}"):
            hs = events_k["histograms"].get(tag, [])
            if ([st for st, _ in hs] != list(range(n_val_k))
                    or any(h["num"] != x.numel() or sum(h["bucket"]) != x.numel()
                           for _, h in hs)):
                fail(f"5k: histogram {tag}: steps {[st for st, _ in hs]}, counts "
                     f"{[(h['num'], sum(h['bucket'])) for _, h in hs]}; the leaf has "
                     f"{x.numel()} elements, {n_val_k} val epochs")
    if len(events_k["histograms"]) != 2 * len(leaves_k):
        fail(f"5k: {len(events_k['histograms'])} histogram tags for {len(leaves_k)} leaves")
    tb_bytes = sum(os.path.getsize(os.path.join(tb_dir, f)) for f in os.listdir(tb_dir))
    print(f"TensorBoard at bench shapes (mlp_meta_mamdr_finetune, histogram_freq 1, "
          f"write_grads): run() {run_k_s:.3f} s, of which the TensorBoard work (scalars, "
          f"weight and gradient histograms, _sample_grads) {tb_s['s']:.3f} s in "
          f"{tb_s['calls']} calls; launches (K1, K1-lanes, K2) {tb_counts[:3]}, K2 split "
          f"{tb_counts[3:]} (5c's run and _sample_grads' one K2 with ids [B]); event files "
          f"read back: {n_scalars} scalars equal to metrics.jsonl's, "
          f"{len(events_k['histograms'])} histograms ({len(leaves_k)} leaves and their "
          f"grad/), each counting its leaf's elements; {tb_bytes} bytes; {card}")

    # the trained parameters through the Keras h5 mapping and back
    model_k = t_k.state.params["model"]
    t0 = time.perf_counter()
    if importlib.util.find_spec("h5py") is not None:
        h5_path = os.path.join(work_k, "trained.h5")
        h5_import.export_reference_weights(h5_path, model_k)
        back_k, rep_k = h5_import.import_reference_weights(h5_path, model_k)
        how_k = f"through a {os.path.getsize(h5_path)}-byte Keras h5 file"
    else:
        listed = [(f"{lname}//{wname}", a)
                  for lname, wname, a in h5_import.reference_layers(model_k)]
        back_k, rep_k = h5_import.import_weights(listed, model_k)
        how_k = ("through the layer list a Keras h5 file holds (no h5py on this machine, so "
                 "no file)")
    torch.cuda.synchronize()
    h5_s = time.perf_counter() - t0
    if (rep_k["skipped"] or rep_k["unmatched_flax"]
            or trees.param_names(back_k) != trees.param_names(model_k)
            or not all(torch.equal(a, b) for a, b in zip(trees.leaves(back_k),
                                                         trees.leaves(model_k)))):
        fail(f"5k: the h5 round trip of the trained parameters is not bit-equal: {rep_k}")
    eval_k = t_k.fused_eval_fn()
    l_a, a_a = eval_k(t_k.state.params, t_k.eval_block("val"), stats=t_k.state.batch_stats)
    l_b, a_b = eval_k({**t_k.state.params, "model": back_k}, t_k.eval_block("val"),
                      stats=t_k.state.batch_stats)
    if not (torch.equal(l_a, l_b) and torch.equal(a_a, a_b)):
        fail("5k: the eval on the imported parameters differs from the eval on the originals")
    print(f"Keras h5 round trip of the trained parameters ({len(rep_k['matched'])} leaves) "
          f"{how_k}: {h5_s:.3f} s, every leaf bit-equal; the val eval on them equal to the "
          f"original's (macro AUC {float(a_b.mean()):.6f}); {card}")
    del strat_k, t_k, trainer, model_k, back_k, eval_k
    shutil.rmtree(work_k, ignore_errors=True)
    torch.cuda.empty_cache()

    # ---- 5l. the DR lanes in groups, with trainable tables ----
    # mlp_meta_mamdr_finetune at bench shapes with the Amazon corpus's table
    # setting (load_pretrain_emb false, emb_trainable true: every lane stacks
    # its own [100000, 128] user and item tables and their Adam slots), under
    # deterministic algorithms (5i): the DN phase, then the DR phase with no
    # dr_lane_chunk, which the JAX package's rule makes groups of 7 (5 groups
    # over 30 domains), then the same DR phase from the same entry (state,
    # shared, specific, device generator) with dr_lane_chunk 30, one group,
    # as the reference. Each DR phase with its launch counts (derived from the
    # groups' real steps), seconds, peak memory and lane-state bytes; the two
    # held to each other (specific stack, state, val losses and AUCs).
    work_l = tempfile.mkdtemp(prefix="mamdr_chip_smoke_5l_")
    strat_l = bench_mamdr(work_l, "chunks", load_pretrain_emb=False, emb_trainable=True)
    t_l = strat_l.trainer
    d_l = mem.n_domain
    spd_l = t_l.steps_per_domain()
    cap_l = strat_l.tc.domain_regulation_step

    def group_lane_steps(order_, aux_, group):
        """The lane-steps of a DR phase in groups of `group` lanes: per group
        and support run, its longest support epoch and its longest (capped)
        query epoch."""
        total = 0
        for start in range(0, len(order_), group):
            o, a = order_[start:start + group], aux_[start:start + group]
            for j in range(a.shape[1]):
                total += (max(spd_l[s] for s in a[:, j])
                          + max(min(spd_l[q], cap_l) if cap_l > 0 else spd_l[q] for q in o))
        return total

    def lane_state_bytes(group):
        """Bytes of the lane state of one group: every trainable leaf and its
        two Adam slots, a copy a lane."""
        frozen_ = trees.leaves(t_l.frozen_mask())
        per_lane = sum(x.numel() * 4 for x, f in zip(trees.leaves(t_l.state.params), frozen_)
                       if not f)
        return 3 * group * per_lane

    def dr_run():
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        t0_ = time.perf_counter()
        strat_l.run_dr_phase()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0_, counts() + k2_split(),
                torch.cuda.max_memory_allocated())

    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught_l:
        warnings.simplefilter("default")
        strat_l.prepare_fused()
        if not strat_l.dr_lanes or strat_l._dr_lane_chunk_effective != 7:
            fail(f"5l: DR lanes {strat_l.dr_lanes}, in groups of "
                 f"{strat_l._dr_lane_chunk_effective}; expected groups of 7")
        zero_counts()
        strat_l.run_dn_phase()
        dn_l_counts = counts() + k2_split()
        entry_l = (t_l.state, strat_l.shared, list(strat_l.specific), t_l.gen.get_state())
        dr7_s, dr7_counts, dr7_peak = dr_run()
        state7, stack7, gen7 = t_l.state, strat_l._spec_stack, t_l.gen.get_state()
        t_l.state, strat_l.shared, strat_l.specific = entry_l[0], entry_l[1], list(entry_l[2])
        t_l.gen.set_state(entry_l[3])
        strat_l.tc.dr_lane_chunk = d_l
        strat_l.prepare_fused()
        if strat_l._dr_lane_chunk_effective != d_l:
            fail(f"5l: dr_lane_chunk {d_l} gave groups of {strat_l._dr_lane_chunk_effective}")
        dr30_s, dr30_counts, dr30_peak = dr_run()
        state30, stack30 = t_l.state, strat_l._spec_stack
        eval_l = fused.make_fused_eval_merged(t_l.model, t_l.step_cfg, strat_l.mask,
                                              strat_l.tc.merged_method)
        ev7 = eval_l(state7.params, strat_l.shared, stack7, t_l.eval_block("val"))
        ev30 = eval_l(state30.params, strat_l.shared, stack30, t_l.eval_block("val"))
        torch.cuda.synchronize()
    torch.use_deterministic_algorithms(False)
    not_repeatable_l = sorted({str(w.message).split(".")[0] for w in caught_l
                               if "determinis" in str(w.message)})
    if dn_l_counts != (sum(spd_l), 0, sum(spd_l), sum(spd_l), 0):
        fail(f"5l: the DN phase with trainable tables launched {dn_l_counts}, expected "
             f"({sum(spd_l)}, 0, {sum(spd_l)}, {sum(spd_l)}, 0)")
    for c_, got_ in ((7, dr7_counts), (d_l, dr30_counts)):
        steps_ = group_lane_steps(strat_l.order, strat_l.aux, c_)
        if got_ != (0, steps_, steps_, 0, steps_):
            fail(f"5l: the DR phase in groups of {c_} launched (K1, K1-lanes, K2, K2 ids [B], "
                 f"K2 ids [L, B]) {got_}, expected (0, {steps_}, {steps_}, 0, {steps_})")
    if not torch.equal(gen7, t_l.gen.get_state()):
        fail("5l: the grouped and the one-group DR phase drew differently from the generator")
    diffs_l = {
        "specific stack": tree_rel(stack7, stack30),
        "params": tree_rel(state7.params, state30.params),
        "Adam slots": tree_rel({"mu": state7.opt_state.mu, "nu": state7.opt_state.nu},
                               {"mu": state30.opt_state.mu, "nu": state30.opt_state.nu}),
        "val losses and AUCs": tree_rel(dict(zip("la", ev7)), dict(zip("la", ev30))),
    }
    bit_l = (all(same for _, same in diffs_l.values()) and torch.equal(state7.step, state30.step)
             and torch.equal(state7.opt_state.count, state30.opt_state.count))
    worst_l = max(r for r, _ in diffs_l.values())
    if not bit_l and not worst_l <= K1_REL_TOL:
        fail(f"5l: the DR phase in groups of 7 and in one group differ: {diffs_l}")
    trainable_tables = [n for n, x in trees.leaves_with_names(state7.params)
                        if ("user_emb" in n or "item_emb" in n) and x.dim() == 2]
    moved_l = all(not torch.equal(stack7["model"]["embedding"][n][d], entry_specific)
                  for n in ("user_emb", "item_emb") for d, entry_specific in enumerate(
                      [sp["model"]["embedding"][n] for sp in entry_l[2]]))
    if not moved_l:
        fail("5l: a domain's specific user or item table did not move in the grouped DR phase")
    print(f"DR lanes with trainable tables at bench shapes (load_pretrain_emb false, "
          f"emb_trainable true; trainable tables {trainable_tables}): DN phase launches (K1, "
          f"K1-lanes, K2) {dn_l_counts[:3]}; no dr_lane_chunk gives "
          f"groups of 7 ({-(-d_l // 7)} groups over {d_l} domains): {dr7_s:.3f} s, launches "
          f"(K1, K1-lanes, K2) {dr7_counts[:3]}, lane state {lane_state_bytes(7)} bytes a "
          f"group, peak memory {dr7_peak} bytes; one group of {d_l} (dr_lane_chunk {d_l}): "
          f"{dr30_s:.3f} s, launches {dr30_counts[:3]}, lane state {lane_state_bytes(d_l)} "
          f"bytes, peak memory {dr30_peak} bytes; deterministic algorithms on: the specific "
          f"stack, the state, the val losses and AUCs bit-equal {bit_l} (largest difference "
          f"{worst_l:.2e} of a tensor's max, tol {'0' if bit_l else K1_REL_TOL}); every "
          f"domain's specific tables moved; ops reported without a deterministic version: "
          f"{not_repeatable_l or 'none'}; {card}")
    del strat_l, t_l, entry_l, state7, stack7, state30, stack30, eval_l, ev7, ev30
    shutil.rmtree(work_l, ignore_errors=True)
    torch.cuda.empty_cache()

    # K1-lanes at 7 lanes and K2 on lane-stacked trainable tables, 7 lanes (a
    # group's shape) and 30 (one group's), against their plain versions and
    # timed; the tables drawn on the device
    lanes7 = 7
    per7 = [tower_inputs({1: "partial"}.get(l, "mixed")) for l in range(lanes7)]
    args7 = (*(torch.stack([p[i] for p in per7]) for i in range(3)),
             torch.from_numpy(rng.integers(0, 2**32, (lanes7, len(dims) - 1),
                                           dtype=np.int64)).to(dev),
             tuple(torch.stack([p[4][i] for p in per7]) for i in range(len(per7[0][4]))))
    k1l7 = k1_vs_plain(fused_tower_grad_lanes, tower_grad_reference_lanes, *args7, dims, 0.5,
                       K1_REL_TOL)
    k1l7_ms = device_ms(lambda: fused_tower_grad_lanes(*args7, dims, 0.5), inner=5)
    k1l7_plain_ms = device_ms(lambda: tower_grad_reference_lanes(*args7, dims, 0.5), inner=2)
    k1l7_bound = lanes7 * k1_bound
    print(f"K1 lanes at a group's shape ({lanes7} lanes): {report(k1l7)}; "
          f"{k1l7_ms * 1e3:.1f} us/call, plain {k1l7_plain_ms * 1e3:.1f} us, bound "
          f"{k1l7_bound * 1e3:.1f} us; {card}")
    gen_t = torch.Generator(device=dev).manual_seed(5)
    trained_k2 = {}
    for nl in (lanes7, d_l):
        tabs = (torch.randn((nl, n_rows, dim), generator=gen_t, device=dev) * 0.1,
                torch.randn((nl, n_rows, dim), generator=gen_t, device=dev) * 0.1,
                torch.randn((nl, n_dom, dim), generator=gen_t, device=dev) * 0.01)
        sets_ = [(rand_ids(n_rows, (nl, batch), False), rand_ids(n_rows, (nl, batch), False),
                  rand_ids(n_dom, (nl, 1), False).expand(nl, batch).contiguous())
                 for _ in range(4)]
        edge = (rand_ids(n_rows, (nl, batch)), rand_ids(n_rows, (nl, batch)),
                rand_ids(n_dom, (nl, batch)))
        every_field = (True, True, True)
        x_k, f_k = gather_fields(tabs, edge, train_mask=every_field)
        x_p, f_p = gather_fields_reference(tabs, edge, train_mask=every_field)
        err_ = float((x_k - x_p).abs().max())
        if err_ != 0.0 or not all(torch.equal(a, b) for a, b in zip(f_k, f_p)):
            fail(f"K2 on lane-stacked trainable tables ({nl} lanes) differs from the plain "
                 f"field gather: {err_}")
        t_ = field_timings(tabs, sets_, every_field)
        least_, every_ = field_bound(tabs, sets_, every_field)
        trained_k2[nl] = (err_, t_, least_ / HBM_BYTES * 1e3)
        print(f"K2 gather_fields vs plain on lane-stacked trainable tables [3 fields x "
              f"{nl * batch} ids; {nl}x{n_rows}x{dim} user and item tables, a {nl}x{n_dom}x"
              f"{dim} domain table, ids out of range in every lane; every field's row ids "
              f"written]: max abs err {err_} (tol 0); the row ids equal")
        print(timing_line(f"lane-stacked trainable tables, {nl} lanes ({nl * batch} ids)", t_,
                          least_, every_))
        del tabs, sets_, edge, x_k, x_p, f_k, f_p
        torch.cuda.empty_cache()

    # ---- 5m. bf16 towers and flat_optimizer false ----
    # (a) mlp_meta_mamdr_finetune at bench shapes with compute_dtype bfloat16:
    # the K1 gate sends its tower to autograd (K1 computes float32), so one
    # autograd train step and one autograd lane-step (30 lanes, every lane its
    # own weights) through K2 are held to the same through K2's plain version;
    # then run() with its launch counts (K1 none, K2 as 5c's run), the weights
    # moved and finite. (b) run() with flat_optimizer false (the JAX
    # package's per-leaf optax.adam: the port runs the same Adam and keeps
    # only optax's layout for the resume snapshot) and with it true, both
    # under deterministic algorithms: equal bit for bit, count, mu and nu
    # included; the state to the optax layout and back, bit-equal.
    from mamdr_tpu_torch.train.steps import make_autograd_loss_grad

    work_m = tempfile.mkdtemp(prefix="mamdr_chip_smoke_5m_")
    strat_b = bench_mamdr(work_m, "bf16", model={"compute_dtype": "bfloat16"})
    t_b = trainer = strat_b.trainer  # checked() reads `trainer`
    model_b, cfg_b = t_b.model, t_b.step_cfg
    if "make_autograd_loss_grad" not in make_loss_grad(model_b, cfg_b).__qualname__:
        fail("5m: the bf16 MLP's train step does not take autograd")
    block_b = t_b.train_block()[0]
    batch_b = {k: v[0, :batch].contiguous() for k, v in block_b.items()}
    steps_b = [make_train_step(model_b, t_b.tx, cfg_b,
                               loss_grad=make_autograd_loss_grad(model_b, cfg_b, gather=g))
               for g in (gather_fields, gather_fields_reference)]
    k2_before = gather_fields.launches
    s_bk, l_bk = steps_b[0](t_b.state, batch_b)
    if gather_fields.launches != k2_before + 1:
        fail("5m: the bf16 autograd step did not launch K2 once")
    s_bp, l_bp = steps_b[1](t_b.state, batch_b)
    _, bf_step_rel = worst_errors([l_bk, s_bk.opt_state.mu, s_bk.opt_state.nu],
                                  [l_bp, s_bp.opt_state.mu, s_bp.opt_state.nu])
    frozen_b = t_b.frozen_mask()
    params_bl = trees.tree_map(
        lambda f, x: x if f else torch.stack([x * (1.0 + 0.01 * l) for l in range(lanes)]),
        frozen_b, t_b.state.params)
    cols_bl = {k: v[:, :batch].contiguous() for k, v in block_b.items()}
    seeds_bl = torch.randint(0, 2**32, (lanes, model_b.n_dropout_sites), device=dev,
                             generator=torch.Generator(device=dev).manual_seed(9))
    k2_before = gather_fields.launches
    d_bk, g_bk = make_autograd_loss_grad(model_b, cfg_b)(params_bl, cols_bl, seeds_bl)
    if gather_fields.launches != k2_before + 1:
        fail("5m: the bf16 autograd lane-step did not launch K2 once")
    d_bp, g_bp = make_autograd_loss_grad(model_b, cfg_b, gather=gather_fields_reference)(
        params_bl, cols_bl, seeds_bl)
    got_b = [d_bk] + [g for g in trees.leaves(g_bk) if g is not None]
    want_b = [d_bp] + [g for g in trees.leaves(g_bp) if g is not None]
    _, bf_lane_rel = worst_errors(got_b, want_b)
    if not (bf_step_rel <= K1_REL_TOL and bf_lane_rel <= K1_REL_TOL
            and all(bool(torch.isfinite(g).all()) for g in got_b)):
        fail(f"5m: the bf16 autograd step / lane-step through K2 and through its plain version "
             f"differ by {bf_step_rel} / {bf_lane_rel} of a tensor's max")
    print(f"bf16 tower (compute_dtype bfloat16): the train step takes autograd; one step "
          f"({batch} ids) and one lane-step ({lanes} lanes x {batch} ids, every lane its own "
          f"weights, dropout {model_b.dropout}) through K2 vs its plain version: loss, mu, nu "
          f"within {bf_step_rel:.2e}, losses and {len(got_b) - 1} gradients within "
          f"{bf_lane_rel:.2e} of the tensor's max (tol {K1_REL_TOL})")
    del s_bk, s_bp, params_bl, g_bk, g_bp, got_b, want_b
    params0_b = t_b.state.params
    want_b = run_counts(t_b, t_b.config.train.epoch)
    zero_counts()
    t0 = time.perf_counter()
    res_b = strat_b.run()
    torch.cuda.synchronize()
    bf_s = time.perf_counter() - t0
    bf_counts = counts() + k2_split()
    if bf_counts != want_b:
        fail(f"5m: the bf16 run() launched (K1, K1-lanes, K2, K2 ids [B], K2 ids [L, B]) "
             f"{bf_counts}, expected {want_b}")
    bf_auc, bf_wauc, bf_loss = checked(res_b, "test", "5m bf16 run()")
    moved_b = [not torch.equal(a, b) for (n, a), b in zip(
        trees.leaves_with_names(t_b.state.params), trees.leaves(params0_b))
        if not ("user_emb" in n or "item_emb" in n)]
    if not all(moved_b) or not all(bool(torch.isfinite(x).all())
                                   for x in trees.leaves(t_b.state.params)):
        fail("5m: the bf16 run() left a trainable leaf unmoved or not finite")
    print(f"bf16 run() at bench shapes (mlp_meta_mamdr_finetune): {bf_s:.3f} s; launches "
          f"(K1, K1-lanes, K2) {bf_counts[:3]}, K2 split {bf_counts[3:]}; every trainable "
          f"leaf moved and finite; test macro AUC {bf_auc:.6f}, weighted {bf_wauc:.6f}, loss "
          f"{bf_loss:.6f}; {card}")
    del strat_b, t_b, trainer, params0_b
    torch.cuda.empty_cache()

    runs_m = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught_m:
        warnings.simplefilter("default")
        for flat in (True, False):
            strat_f = bench_mamdr(work_m, f"flat_{flat}", flat_optimizer=flat)
            want_f = run_counts(strat_f.trainer, strat_f.tc.epoch)
            zero_counts()
            t0 = time.perf_counter()
            res_f = strat_f.run()
            torch.cuda.synchronize()
            secs_f = time.perf_counter() - t0
            counts_f = counts() + k2_split()
            if counts_f != want_f:
                fail(f"5m: run() with flat_optimizer {flat} launched {counts_f}, expected "
                     f"{want_f}")
            runs_m[flat] = (strat_f, res_f, secs_f, counts_f)
    torch.use_deterministic_algorithms(False)
    (sf_, rf_, flat_s, flat_counts), (sl_, rl_, leaf_s, leaf_counts) = runs_m[True], runs_m[False]
    tx_l = sl_.trainer.tx
    if tx_l.optax_path != ("1", "inner_state", "0"):
        fail(f"5m: flat_optimizer false with frozen tables keeps the optax path "
             f"{tx_l.optax_path}, not the masked chain's")
    diffs_m = {
        "params": tree_rel(sf_.trainer.state.params, sl_.trainer.state.params),
        "shared": tree_rel(sf_.shared, sl_.shared),
        "specific": max((tree_rel(a, b) for a, b in zip(sf_.specific, sl_.specific)),
                        key=lambda r: r[0]),
        "best_specific": max((tree_rel(a, b) for a, b in zip(sf_.best_specific,
                                                             sl_.best_specific)),
                             key=lambda r: r[0]),
    }
    opt_f, opt_l = sf_.trainer.state.opt_state, sl_.trainer.state.opt_state
    diffs_m["Adam count, mu, nu"] = tree_rel(
        {"count": opt_f.count.float(), "mu": opt_f.mu, "nu": opt_f.nu},
        {"count": opt_l.count.float(), "mu": opt_l.mu, "nu": opt_l.nu})
    back_l = tx_l.from_optax(tx_l.to_optax(opt_l, sl_.trainer.state.params))
    diffs_m["optax layout and back"] = tree_rel(
        {"count": opt_l.count.float(), "mu": opt_l.mu, "nu": opt_l.nu},
        {"count": back_l.count.float(), "mu": back_l.mu, "nu": back_l.nu})
    bit_m = all(same for _, same in diffs_m.values()) and rf_ == rl_
    worst_m = max(r for r, _ in diffs_m.values())
    not_repeatable_m = sorted({str(w.message).split(".")[0] for w in caught_m
                               if "determinis" in str(w.message)})
    if not bit_m:
        fail(f"5m: run() with flat_optimizer false differs from run() with it true: "
             f"{diffs_m}; test results equal {rf_ == rl_}")
    print(f"flat_optimizer false at bench shapes (mlp_meta_mamdr_finetune, deterministic "
          f"algorithms on): run() {leaf_s:.3f} s, launches {leaf_counts[:3]}; with it true "
          f"run() {flat_s:.3f} s, launches {flat_counts[:3]}; the params, shared, every "
          f"specific, the best snapshot, the Adam state's count, mu and nu, the state through "
          f"the snapshot's optax layout and back, and the test losses and AUCs bit-equal "
          f"{bit_m} (largest difference {worst_m:.2e}); ops reported without a "
          f"deterministic version: {not_repeatable_m or 'none'}; {card}")
    del runs_m, sf_, sl_, mem
    shutil.rmtree(work_m, ignore_errors=True)
    torch.cuda.empty_cache()

    # ---- 5n. the mesh: row-sharded tables through K2, data-parallel steps through K1 ----
    # (a) K2 with row windows, as a (., 2) mesh's lookup runs it: the user and
    # item tables as shard t of two ([50000, 128] each, WINDOW: zeros outside,
    # the spare row as the row id), the domain field with the clamp at table
    # index 0 and SILENT at 1; at the DN step's shapes (1024 ids) and the DR
    # lane-step's (30 lanes x 1024, a lane-stacked domain table). Exact against
    # the plain version at both table indices, the two shards' x summed equal
    # to the unsharded gather; timed at table index 1 beside the plain version
    # and the library call (torch.where after F.embedding, a field each).
    half = n_rows // 2
    w_tables = (rand_table((n_rows, dim)), rand_table((n_rows, dim)))
    w_dom = {"dn": rand_table((n_dom, dim), 1e-4), "dr": rand_table((lanes, n_dom, dim), 1e-2)}
    w_shape = {"dn": (batch,), "dr": (lanes, batch)}

    def w_sets(what, k):
        shape = w_shape[what]
        dom = (torch.full(shape, 7, dtype=torch.int32, device=dev) if what == "dn" else
               rand_ids(n_dom, (lanes, 1), False).expand(lanes, batch).contiguous())
        return [(rand_ids(n_rows, shape, k == 0), rand_ids(n_rows, shape, k == 0), dom)
                for _ in range(max(k, 1))]

    def w_fields(what, ti):
        return ((w_tables[0][ti * half:(ti + 1) * half], w_tables[1][ti * half:(ti + 1) * half],
                 w_dom[what]),
                ((ti * half, WINDOW), (ti * half, WINDOW), (0, CLAMP if ti == 0 else SILENT)))

    def w_library(shards, win, ids_):
        parts = []
        for t_, (lo, mode), i in zip(shards, win, ids_):
            v = t_.reshape(-1, dim)
            local = i.long() - lo if mode == WINDOW else i.long()
            inside = ((local >= 0) & (local < t_.shape[-2]))[..., None]
            if t_.dim() == 3:
                local = local.clamp(0, t_.shape[-2] - 1) + torch.arange(
                    t_.shape[0], device=dev)[:, None] * t_.shape[-2]
            rows = torch.nn.functional.embedding(local.clamp(0, v.shape[0] - 1), v)
            parts.append(torch.where(inside, rows, 0.0) if mode == WINDOW else
                         (rows if mode == CLAMP else torch.zeros_like(rows)))
        return torch.cat(parts, dim=-1)

    win_t, win_bound, win_err = {}, {}, 0.0
    for what in ("dn", "dr"):
        check_ids = w_sets(what, 0)[0]
        xs = []
        for ti in (0, 1):
            shards, win = w_fields(what, ti)
            x_k, f_k = gather_fields(shards, check_ids, train_mask=mask, windows=win)
            x_p, f_p = gather_fields_reference(shards, check_ids, mask, win)
            torch.cuda.synchronize()
            err = float((x_k - x_p).abs().max())
            win_err = max(win_err, err)
            if err != 0.0 or not all((a is None and b is None) or torch.equal(a, b)
                                     for a, b in zip(f_k, f_p)):
                fail(f"5n: K2 with row windows at the {what} shape, table index {ti}, differs "
                     f"from its plain version: max abs err {err}")
            xs.append(x_k)
        whole_x = gather_fields((*w_tables, w_dom[what]), check_ids)[0]
        inside = [((i >= 0) & (i < n_rows))[..., None] for i in check_ids[:2]]
        whole_x = torch.cat([torch.where(inside[0], whole_x[..., :dim], 0.0),
                             torch.where(inside[1], whole_x[..., dim:2 * dim], 0.0),
                             whole_x[..., 2 * dim:]], dim=-1)
        if not torch.equal(xs[0] + xs[1], whole_x):
            fail(f"5n: the two shards' windowed gathers do not sum to the whole gather ({what})")
        shards, win = w_fields(what, 1)
        sets = w_sets(what, 4)
        win_t[what] = {
            "k2": device_ms(lambda: in_turn(lambda s_: gather_fields(
                shards, s_, train_mask=mask, windows=win), sets), inner=48),
            "plain": device_ms(lambda: in_turn(lambda s_: gather_fields_reference(
                shards, s_, mask, win), sets), inner=48),
            "library": device_ms(lambda: in_turn(lambda s_: w_library(shards, win, s_), sets),
                                 inner=48)}
        least = 0
        for s_ in sets:  # ids read, x and the marked row ids written, rows inside read once
            n_ids = s_[0].numel()
            rows_read = sum(int(torch.unique(i[(i >= lo) & (i < lo + half)]).numel())
                            for i, (lo, _) in zip(s_[:2], win[:2]))
            dom_rows = 0  # SILENT: the domain table is not read
            least += 4 * n_ids * (3 + 3 * dim + sum(mask)) + 4 * dim * (rows_read + dom_rows)
        win_bound[what] = least / len(sets) / HBM_BYTES * 1e3
        ids_n = "x".join(map(str, w_shape[what]))
        print(f"5n: K2 with row windows at the {what.upper()} shape ({ids_n} ids, 3 fields, "
              f"shard 1 of 2: {half}x{dim} user and item shards, the domain "
              f"field SILENT): exact against the plain version at both table indices, the two "
              f"shards' x summed equal to the whole gather; {win_t[what]['k2'] * 1e3:.2f} "
              f"us/call, plain {win_t[what]['plain'] * 1e3:.2f} us, torch.where after "
              f"F.embedding {win_t[what]['library'] * 1e3:.2f} us, bound "
              f"{win_bound[what] * 1e3:.3f} us (bytes); unwindowed K2 at this shape "
              f"{(dn_t if what == 'dn' else dr_t)['k2'] * 1e3:.2f} us (4, 4a); {card}")
    del w_tables, w_dom

    # (b) the bench workload (mlp_meta_mamdr_finetune at Taobao-30 shapes,
    # uncut) on three meshes of ranks on this one card, each rank a process
    # of mamdr_tpu_torch.parallel.dryrun --bench with deterministic
    # algorithms on before its first CUDA call: (1, 1) over NCCL with a whole
    # run() after the epoch; (1, 2) and (2, 1) over gloo with CUDA tensors
    # (NCCL refuses two ranks on one card); and the one-device reference in a
    # process of its own with the same settings. Beside them, the dry run's
    # tiny steps (1, 1c, 1d, 1e, 1f: the JAX package's dryrun_multichip and
    # MMoE with shard_experts) on (1, 2) over gloo. All nine run at once.
    work_n = tempfile.mkdtemp(prefix="mamdr_chip_smoke_5n_")
    repo_root = os.path.dirname(os.path.abspath(__file__))
    env_n = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8", "GLOO_SOCKET_IFNAME": "lo",
             "NCCL_SOCKET_IFNAME": "lo", "LOCAL_RANK": "0", "OMP_NUM_THREADS": "1",
             "PYTHONPATH": repo_root + os.pathsep + os.environ.get("PYTHONPATH", "")}
    # (c) before their epoch, the (1, 2) ranks and the reference run the
    # resume run of dryrun.bench_resume (run() of 2 epochs, the snapshot
    # every epoch, TensorBoard with weight and gradient histograms); the
    # (1, 2) ranks copy their first snapshot aside, and two fresh (1, 2)
    # ranks ("1x2c"), started with the others, wait for it and resume.
    layouts = {"ref": (1, 1, None, True), "1x1": (1, 1, "nccl", True),
               "1x2": (2, 2, "gloo", False), "2x1": (2, 1, "gloo", False),
               "dry": (2, 2, "gloo", False), "1x2c": (2, 2, "gloo", False)}
    procs_n = []
    t0 = time.perf_counter()
    for tag, (world, tbl, backend, with_run) in layouts.items():
        for r in range(world):
            cmd = [sys.executable, "-m", "mamdr_tpu_torch.parallel.dryrun"]
            if tag == "1x2c":
                cmd += ["--resumed-run", os.path.join(work_n, "1x2c_resume.npz"),
                        "--deterministic"]
            elif tag != "dry":
                cmd += ["--bench", os.path.join(work_n, f"{tag}.npz"), "--deterministic"]
            else:
                cmd += ["--checkpoint-dir", os.path.join(work_n, "dry.ckpt")]
            if tag in ("ref", "1x2"):
                cmd += ["--resume-run", os.path.join(work_n, f"{tag}_resume.npz")]
            if tag == "1x2":
                cmd += ["--snapshot-to", os.path.join(work_n, "1x2c_resume.npz.ckpt")]
            if tag == "2x1":  # DR and validation from the reference's post-DN state
                cmd += ["--dr-from", os.path.join(work_n, "ref.npz")]
            cmd += ["--run"] if with_run else []
            cmd += (["--one-device"] if backend is None else
                    ["--table", str(tbl), "--backend", backend,
                     "--init-method", f"file://{os.path.join(work_n, 'store_' + tag)}"])
            log = open(os.path.join(work_n, f"{tag}.rank{r}.log"), "w")
            procs_n.append((tag, r, log, subprocess.Popen(
                cmd, cwd=repo_root, stdout=log, stderr=subprocess.STDOUT,
                env={**env_n, "RANK": str(r), "WORLD_SIZE": str(world)})))
    deadline = time.time() + 600
    for tag, r, log, p in procs_n:
        try:
            rc = p.wait(timeout=max(deadline - time.time(), 1))
        except subprocess.TimeoutExpired:
            rc = "timeout"
        log.close()
        if rc != 0:
            for *_, q in procs_n:  # stop every rank before failing
                if q.poll() is None:
                    q.kill()
                    q.wait()
            with open(os.path.join(work_n, f"{tag}.rank{r}.log")) as f:
                tail = f.read()[-3000:]
            fail(f"5n: the {tag} rank {r} ended with {rc}:\n{tail}")
    mesh_s = time.perf_counter() - t0
    with open(os.path.join(work_n, "dry.rank0.log")) as f:
        dry = json.loads([ln for ln in f.read().splitlines() if ln.startswith("{")][-1])
    if sorted(dry) != ["1", "1c", "1d", "1e", "1f", "mesh"] or dry["1f"]["experts_held"] != 2:
        fail(f"5n: the dry run on (1, 2) gave {dry}")
    print(f"5n: the dry run on (1, 2) over gloo (steps 1, 1c, 1d, 1e, and 1f: MMoE with "
          f"shard_experts, 2 of 4 experts a rank): every result finite; {json.dumps(dry)}")
    layouts.pop("dry")
    layouts.pop("1x2c")
    for line in check_resume_tb(work_n):
        print(f"{line}; {card}")

    def rank_json(tag, r):
        with open(os.path.join(work_n, f"{tag}.npz.rank{r}.json")) as f:
            return json.load(f)

    with np.load(os.path.join(work_n, "ref.npz")) as z:
        ref_n = {k: z[k] for k in z.files}
    ref_j = rank_json("ref", 0)
    if not ref_j["dr_lanes"]:
        fail("5n: the reference's DR phase did not take the lanes")
    phases_n = ("dn", "dr", "val")
    mesh_res = {}
    for tag, (world, tbl, backend, with_run) in layouts.items():
        if backend is None:
            continue
        with np.load(os.path.join(work_n, f"{tag}.npz")) as z:
            got = {k: z[k] for k in z.files}
        want_keys = sorted(k for k in ref_n if with_run or not k.startswith(("run_", "best/")))
        if sorted(got) != want_keys:
            fail(f"5n {tag}: arrays {sorted(got)} differ from the reference's {want_keys}")
        for r in range(world):
            j = rank_json(tag, r)
            for ph in phases_n + (("run",) if with_run else ()):
                c, cr = j[f"{ph}_counts"], ref_j[f"{ph}_counts"]
                if c[:4] != cr[:4] or c[4] != c[2]:
                    fail(f"5n {tag} rank {r}: {ph} launched (K1, K1-lanes, K2, K2 ids [L, B], "
                         f"K2 windowed) {c}, expected the one device's {cr[:4]} with every "
                         f"K2 launch windowed")
        def apart(keys):
            return max(float(np.max(np.abs(got[k].astype(np.float64) - ref_n[k]))
                             / max(float(np.max(np.abs(ref_n[k]))), 1e-30)) for k in keys)

        if not all(np.all(np.isfinite(v)) for v in got.values()):
            fail(f"5n {tag}: a result is not finite")
        if tag in ("1x1", "1x2"):
            exact = [k for k in got if k != "val_loss" or tag == "1x1"]
            diff = [k for k in exact if not np.array_equal(got[k], ref_n[k])]
            if diff:
                fail(f"5n {tag}: not bit-equal to one device: {diff[:8]}")
            vl = float(np.max(np.abs(got["val_loss"] - ref_n["val_loss"])
                              / np.abs(ref_n["val_loss"])))
            if vl > 1e-6:
                fail(f"5n {tag}: validation losses part by {vl} (tol 1e-6 relative)")
            mesh_res[tag] = f"bit-equal (val loss within {vl:.1e})"
        else:
            # the data-parallel step sums its rows' gradients in another
            # order: one step from the same state is held to 1e-5 of each
            # tensor's max; the DN phase's 360 Adam steps on random labels
            # carry such last bits to steps of order lr (as two unbroken
            # one-device runs without deterministic algorithms part, 5i), so
            # its losses' distance is reported, not gated. The DR phase and
            # the validation start from the reference's post-DN state
            # (--dr-from): each data rank's lanes, the spec stack gathered
            # as a zero-filled sum, the last lane's state broadcast from the
            # last data rank and the split validation's gathered counts are
            # held bit-equal to one device
            step_d = apart(["step_loss", "step_mu", "step_nu"])
            if not step_d <= 1e-5:
                fail(f"5n {tag}: one data-parallel step is {step_d} of a tensor's max apart "
                     f"from one device's (tol 1e-5)")
            exact = [k for k in got if not k.startswith("step_")
                     and k not in ("dn_losses", "val_loss")]
            diff = [k for k in exact if not np.array_equal(got[k], ref_n[k])]
            if diff:
                fail(f"5n {tag}: DR or validation from the reference's post-DN state not "
                     f"bit-equal to one device: {diff[:8]}")
            vl = float(np.max(np.abs(got["val_loss"] - ref_n["val_loss"])
                              / np.abs(ref_n["val_loss"])))
            if vl > 1e-6:
                fail(f"5n {tag}: validation losses part by {vl} (tol 1e-6 relative)")
            dn_d = apart(["dn_losses"])
            mesh_res[tag] = (f"one step within {step_d:.2e} of a tensor's max (tol 1e-5); "
                             f"DN losses {dn_d:.2e} of their max apart (not gated: Adam on "
                             f"random labels); DR and validation from the reference's "
                             f"post-DN state bit-equal ({len(exact)} arrays; val loss within "
                             f"{vl:.1e})")
    for tag, (world, tbl, backend, with_run) in layouts.items():
        j = rank_json(tag, 0)
        print(f"5n {tag if backend else 'one device'} ({'reference, ' if not backend else ''}"
              f"{world} rank{'s' if world > 1 else ''}, table axis {tbl}"
              f"{', ' + backend if backend else ''}): set-up {j['setup_s']:.1f} s, DN "
              f"{j['dn_s']:.2f} s, DR {j['dr_s']:.2f} s, validation {j['val_s']:.2f} s"
              f"{', run() %.1f s' % j['run_s'] if with_run else ''}; launches per rank (K1, "
              f"K1-lanes, K2, K2 ids [L, B], K2 windowed) DN {j['dn_counts']}, DR "
              f"{j['dr_counts']}, val {j['val_counts']}"
              f"{', run() %s' % j['run_counts'] if with_run else ''}"
              f"{'; ' + mesh_res[tag] if backend else ''}; {card}")
    print(f"5n: {len(procs_n)} processes at once on one card, {mesh_s:.1f} s wall (their times above "
          f"overlap); every rank's launch counts equal one device's; {card}")
    win_1x2 = [rank_json("1x2", r) for r in range(2)]
    win_one = [sum(j[f"{ph}_counts"][4] - j[f"{ph}_counts"][3] for ph in phases_n)
               for j in win_1x2]
    win_lane = [sum(j[f"{ph}_counts"][3] for ph in phases_n) for j in win_1x2]
    shutil.rmtree(work_n, ignore_errors=True)

    # ---- 6. kernels ----
    print(json.dumps({"kernels": [
        {"name": "fused_tower_grad", "route": "cuda",
         "source": "mamdr_tpu_torch/csrc/fused_mlp_step.cu",
         "replaces": "mamdr_tpu/ops/fused_mlp_step.py:141",
         "launches": k1_launches, "max_abs_err": k1_err, "relu_edge_units": k1_flips,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": "operations", "library_ms": None},
        {"name": "fused_tower_grad_lanes", "route": "cuda",
         "source": "mamdr_tpu_torch/csrc/fused_mlp_step.cu",
         "replaces": "mamdr_tpu/ops/fused_mlp_step.py:141",
         "launches": k1l_launches, "max_abs_err": k1l_err, "relu_edge_units": k1l_flips,
         "ms": k1l_ms, "plain_ms": k1l_plain_ms, "bound_ms": k1l_bound,
         "bound_by": "operations", "library_ms": None},
        # K2 twice: the DN step's shape (3 fields x 1024 ids) with the DN
        # phase's launches, and the DR lane-step's (3 x 30720) with the DR
        # phase's; library_ms is torch.cat of three F.embedding calls, and
        # replaced_route_ms the three one-field launches and torch.cat
        {"name": f"gather_fields (3 fields x {batch} ids, the DN step)", "route": "cuda",
         "source": "mamdr_tpu_torch/csrc/gather_rows.cu",
         "replaces": "mamdr_tpu/ops/embedding_lookup.py:56",
         "launches": k2_launches, "max_abs_err": k2_err,
         "ms": dn_t["k2"], "plain_ms": dn_t["plain"], "bound_ms": k2_bound,
         "bound_by": "bytes", "library_ms": dn_t["library"],
         "replaced_route_ms": dn_t["route"]},
        {"name": f"gather_fields (3 fields x {lanes * batch} ids, the DR lane-step)",
         "route": "cuda", "source": "mamdr_tpu_torch/csrc/gather_rows.cu",
         "replaces": "mamdr_tpu/ops/embedding_lookup.py:56",
         "launches": k2_dr_launches, "max_abs_err": k2l_err,
         "ms": dr_t["k2"], "plain_ms": dr_t["plain"], "bound_ms": k2l_bound,
         "bound_by": "bytes", "library_ms": dr_t["library"],
         "replaced_route_ms": dr_t["route"]},
        # The eval and finetune paths (5c), at the DR lane-step's shapes: K2 in
        # the eval's call (no row ids; launches of the validation and the
        # test), K2 and K1-lanes in the finetune (its launches; timed in 3b
        # and 4a at the same shapes)
        {"name": f"gather_fields (3 fields x {lanes * batch} ids, the eval lane-step)",
         "route": "cuda", "source": "mamdr_tpu_torch/csrc/gather_rows.cu",
         "replaces": "mamdr_tpu/ops/embedding_lookup.py:56",
         "launches": val_counts[2] + test_counts[2], "max_abs_err": eval_err,
         "ms": ev_t["k2"], "plain_ms": ev_t["plain"], "bound_ms": k2e_bound,
         "bound_by": "bytes", "library_ms": dr_t["library"]},
        {"name": f"gather_fields (3 fields x {lanes * batch} ids, the finetune)",
         "route": "cuda", "source": "mamdr_tpu_torch/csrc/gather_rows.cu",
         "replaces": "mamdr_tpu/ops/embedding_lookup.py:56",
         "launches": ft_counts[2], "max_abs_err": k2l_err,
         "ms": dr_t["k2"], "plain_ms": dr_t["plain"], "bound_ms": k2l_bound,
         "bound_by": "bytes", "library_ms": dr_t["library"]},
        {"name": "fused_tower_grad_lanes (the finetune)", "route": "cuda",
         "source": "mamdr_tpu_torch/csrc/fused_mlp_step.cu",
         "replaces": "mamdr_tpu/ops/fused_mlp_step.py:141",
         "launches": ft_counts[1], "max_abs_err": k1f["err"], "relu_edge_units": k1f["flips"],
         "ms": k1l_ms, "plain_ms": k1l_plain_ms, "bound_ms": k1l_bound,
         "bound_by": "operations", "library_ms": None},
        # 5d's runs (joint, finetune, separate, DN, Reptile at bench shapes):
        # K1 and K2 at the train step's shapes on every joint / DN / Reptile
        # step, K1-lanes and K2 at the lane-step's shapes in the separate and
        # finetune lanes and the evals; times from phases 3-4a at the same
        # shapes
        {"name": "fused_tower_grad (joint, DN and Reptile runs)", "route": "cuda",
         "source": "mamdr_tpu_torch/csrc/fused_mlp_step.cu",
         "replaces": "mamdr_tpu/ops/fused_mlp_step.py:141",
         "launches": sum(c[0] for c in new_counts.values()), "max_abs_err": k1_err,
         "relu_edge_units": k1_flips, "ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound, "bound_by": "operations", "library_ms": None},
        {"name": "fused_tower_grad_lanes (separate and finetune lanes of 5d)", "route": "cuda",
         "source": "mamdr_tpu_torch/csrc/fused_mlp_step.cu",
         "replaces": "mamdr_tpu/ops/fused_mlp_step.py:141",
         "launches": sum(c[1] for c in new_counts.values()), "max_abs_err": k1l_err,
         "relu_edge_units": k1l_flips, "ms": k1l_ms, "plain_ms": k1l_plain_ms,
         "bound_ms": k1l_bound, "bound_by": "operations", "library_ms": None},
        {"name": f"gather_fields (3 fields x {batch} ids, joint, DN and Reptile steps)",
         "route": "cuda", "source": "mamdr_tpu_torch/csrc/gather_rows.cu",
         "replaces": "mamdr_tpu/ops/embedding_lookup.py:56",
         "launches": sum(c[3] for c in new_counts.values()), "max_abs_err": k2_err,
         "ms": dn_t["k2"], "plain_ms": dn_t["plain"], "bound_ms": k2_bound,
         "bound_by": "bytes", "library_ms": dn_t["library"]},
        {"name": f"gather_fields (3 fields x {lanes * batch} ids, 5d's lanes and evals)",
         "route": "cuda", "source": "mamdr_tpu_torch/csrc/gather_rows.cu",
         "replaces": "mamdr_tpu/ops/embedding_lookup.py:56",
         "launches": sum(c[4] for c in new_counts.values()), "max_abs_err": k2l_err,
         "ms": dr_t["k2"], "plain_ms": dr_t["plain"], "bound_ms": k2l_bound,
         "bound_by": "bytes", "library_ms": dr_t["library"]},
        # 5e's runs (MAML, MLDG, PCGrad, uncertainty weighting at bench
        # shapes): K1 on MAML's inner steps (rate 0.5) and on every accumulate
        # step (rate 0: its time and error from 5e's accumulate-step check),
        # K2 at the step's shapes on every step and accumulate step and in
        # uncertainty weighting's autograd forward, K1-lanes and K2 at the
        # lane-step's shapes in the finetune lanes and the evals
        {"name": "fused_tower_grad (MAML, MLDG and PCGrad runs; rate 0 accumulate steps)",
         "route": "cuda", "source": "mamdr_tpu_torch/csrc/fused_mlp_step.cu",
         "replaces": "mamdr_tpu/ops/fused_mlp_step.py:141",
         "launches": sum(c[0] for c in meta_counts.values()), "max_abs_err": k1a["err"],
         "relu_edge_units": k1a["flips"], "ms": k1a_ms, "plain_ms": k1a_plain_ms,
         "bound_ms": k1_bound, "bound_by": "operations", "library_ms": None},
        {"name": "fused_tower_grad_lanes (5e's finetune lanes)", "route": "cuda",
         "source": "mamdr_tpu_torch/csrc/fused_mlp_step.cu",
         "replaces": "mamdr_tpu/ops/fused_mlp_step.py:141",
         "launches": sum(c[1] for c in meta_counts.values()), "max_abs_err": k1l_err,
         "relu_edge_units": k1l_flips, "ms": k1l_ms, "plain_ms": k1l_plain_ms,
         "bound_ms": k1l_bound, "bound_by": "operations", "library_ms": None},
        {"name": f"gather_fields (3 fields x {batch} ids, 5e's steps and accumulate steps)",
         "route": "cuda", "source": "mamdr_tpu_torch/csrc/gather_rows.cu",
         "replaces": "mamdr_tpu/ops/embedding_lookup.py:56",
         "launches": sum(c[3] for c in meta_counts.values()), "max_abs_err": k2_err,
         "ms": dn_t["k2"], "plain_ms": dn_t["plain"], "bound_ms": k2_bound,
         "bound_by": "bytes", "library_ms": dn_t["library"]},
        {"name": f"gather_fields (3 fields x {lanes * batch} ids, 5e's lanes and evals)",
         "route": "cuda", "source": "mamdr_tpu_torch/csrc/gather_rows.cu",
         "replaces": "mamdr_tpu/ops/embedding_lookup.py:56",
         "launches": sum(c[4] for c in meta_counts.values()), "max_abs_err": k2l_err,
         "ms": dr_t["k2"], "plain_ms": dr_t["plain"], "bound_ms": k2l_bound,
         "bound_by": "bytes", "library_ms": dr_t["library"]},
        # 5f's runs (the zoo's joint names, MAMDR on DeepFM and MMoE): K2 at
        # the step's shapes on every autograd step (forward; its autograd
        # rule's backward is an index_add_), at the lane-step's shapes on
        # every autograd lane-step of DR and the finetune and in the evals;
        # no K1. max_abs_err: K2 exact against its plain version (4, 4a);
        # the autograd lane step through K2 held to it in 5f
        {"name": f"gather_fields (3 fields x {batch} ids, 5f's autograd steps)",
         "route": "cuda", "source": "mamdr_tpu_torch/csrc/gather_rows.cu",
         "replaces": "mamdr_tpu/ops/embedding_lookup.py:56",
         "launches": sum(c[3] for c in zoo_counts.values()), "max_abs_err": k2_err,
         "ms": dn_t["k2"], "plain_ms": dn_t["plain"], "bound_ms": k2_bound,
         "bound_by": "bytes", "library_ms": dn_t["library"]},
        {"name": f"gather_fields (3 fields x {lanes * batch} ids, 5f's autograd lane-steps "
                 "and evals)",
         "route": "cuda", "source": "mamdr_tpu_torch/csrc/gather_rows.cu",
         "replaces": "mamdr_tpu/ops/embedding_lookup.py:56",
         "launches": sum(c[4] for c in zoo_counts.values()), "max_abs_err": k2l_err,
         "autograd_lane_step_rel_err": max(zoo_lane.values()),
         "ms": dr_t["k2"], "plain_ms": dr_t["plain"], "bound_ms": k2l_bound,
         "bound_by": "bytes", "library_ms": dr_t["library"]},
        # 5g's runs (star joint, star_meta_mamdr_finetune): K2 at the step's
        # shapes on every autograd step (joint, DN and the sequential DR), at
        # the lane-step's shapes on the finetune's autograd lane-steps and in
        # the evals; no K1. STAR's step and lane-step through K2 held to K2's
        # plain version in 5g
        {"name": f"gather_fields (3 fields x {batch} ids, 5g's STAR steps)",
         "route": "cuda", "source": "mamdr_tpu_torch/csrc/gather_rows.cu",
         "replaces": "mamdr_tpu/ops/embedding_lookup.py:56",
         "launches": sum(c[3] for c in star_counts.values()), "max_abs_err": k2_err,
         "autograd_step_rel_err": star_step_rel,
         "ms": dn_t["k2"], "plain_ms": dn_t["plain"], "bound_ms": k2_bound,
         "bound_by": "bytes", "library_ms": dn_t["library"]},
        {"name": f"gather_fields (3 fields x {lanes * batch} ids, 5g's STAR lane-steps and "
                 "evals)",
         "route": "cuda", "source": "mamdr_tpu_torch/csrc/gather_rows.cu",
         "replaces": "mamdr_tpu/ops/embedding_lookup.py:56",
         "launches": sum(c[4] for c in star_counts.values()), "max_abs_err": k2l_err,
         "autograd_lane_step_rel_err": star_lane_rel,
         "ms": dr_t["k2"], "plain_ms": dr_t["plain"], "bound_ms": k2l_bound,
         "bound_by": "bytes", "library_ms": dr_t["library"]},
        # 5h's per-call runs (MAMDR under fixed_train and with the batch update
        # and finetune_every_epoch, DN with a target and the meta-finetune
        # lanes, MAML with "drop", PCGrad with a target): K1 one lane on every
        # per-call train step (rate 0.5) and accumulate step (rate 0), K2 with
        # ids [B] on each of them and on every evaluate_domain batch, K1-lanes
        # and K2 with ids [L, B] in the meta-finetune and finetune lanes and
        # the lane evals. Errors from 5h's step checks (K1 on the per-call
        # steps' operands), times from phases 3-4a at the same shapes
        {"name": "fused_tower_grad (5h's per-call steps and accumulate steps)",
         "route": "cuda", "source": "mamdr_tpu_torch/csrc/fused_mlp_step.cu",
         "replaces": "mamdr_tpu/ops/fused_mlp_step.py:141",
         "launches": sum(c[0] for c in percall_counts.values()),
         "max_abs_err": max(k1pc["err"], k1pa["err"]),
         "relu_edge_units": k1pc["flips"] + k1pa["flips"],
         "per_call_step_rel_err": pc_step_err, "per_call_accumulate_rel_err": pc_acc_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": "operations", "library_ms": None},
        {"name": "fused_tower_grad_lanes (5h's meta-finetune and finetune lanes)",
         "route": "cuda", "source": "mamdr_tpu_torch/csrc/fused_mlp_step.cu",
         "replaces": "mamdr_tpu/ops/fused_mlp_step.py:141",
         "launches": sum(c[1] for c in percall_counts.values()), "max_abs_err": k1l_err,
         "relu_edge_units": k1l_flips, "ms": k1l_ms, "plain_ms": k1l_plain_ms,
         "bound_ms": k1l_bound, "bound_by": "operations", "library_ms": None},
        {"name": f"gather_fields (3 fields x {batch} ids, 5h's per-call steps, accumulate "
                 "steps and evaluate_domain)",
         "route": "cuda", "source": "mamdr_tpu_torch/csrc/gather_rows.cu",
         "replaces": "mamdr_tpu/ops/embedding_lookup.py:56",
         "launches": sum(c[3] for c in percall_counts.values()), "max_abs_err": k2_err,
         "ms": dn_t["k2"], "plain_ms": dn_t["plain"], "bound_ms": k2_bound,
         "bound_by": "bytes", "library_ms": dn_t["library"]},
        {"name": f"gather_fields (3 fields x {lanes * batch} ids, 5h's lanes and evals)",
         "route": "cuda", "source": "mamdr_tpu_torch/csrc/gather_rows.cu",
         "replaces": "mamdr_tpu/ops/embedding_lookup.py:56",
         "launches": sum(c[4] for c in percall_counts.values()), "max_abs_err": k2l_err,
         "ms": dr_t["k2"], "plain_ms": dr_t["plain"], "bound_ms": k2l_bound,
         "bound_by": "bytes", "library_ms": dr_t["library"]},
        # 5i's resumed run (one MAMDR epoch at bench shapes, test, finetune) and
        # 5j's learning run (Taobao-10 recipe: 10 domains, so 10 lanes): K1 one
        # lane on every DN step, K2 with ids [B] on each; K1-lanes and K2 with
        # ids [L, B] on the DR and finetune lane-steps and the evals. 5i's lane
        # shapes are 3b / 4a's; 5j's are timed in 5j at 10 lanes.
        {"name": "fused_tower_grad (5i's resumed run and 5j's Taobao-10 run)",
         "route": "cuda", "source": "mamdr_tpu_torch/csrc/fused_mlp_step.cu",
         "replaces": "mamdr_tpu/ops/fused_mlp_step.py:141",
         "launches": resume_counts[0] + learn_counts[0], "max_abs_err": k1_err,
         "relu_edge_units": k1_flips, "ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound, "bound_by": "operations", "library_ms": None},
        {"name": f"fused_tower_grad_lanes ({lanes} lanes, 5i's resumed run)", "route": "cuda",
         "source": "mamdr_tpu_torch/csrc/fused_mlp_step.cu",
         "replaces": "mamdr_tpu/ops/fused_mlp_step.py:141",
         "launches": resume_counts[1], "max_abs_err": k1l_err,
         "relu_edge_units": k1l_flips, "ms": k1l_ms, "plain_ms": k1l_plain_ms,
         "bound_ms": k1l_bound, "bound_by": "operations", "library_ms": None},
        {"name": f"fused_tower_grad_lanes ({lanes_j} lanes, 5j's Taobao-10 run)",
         "route": "cuda", "source": "mamdr_tpu_torch/csrc/fused_mlp_step.cu",
         "replaces": "mamdr_tpu/ops/fused_mlp_step.py:141",
         "launches": learn_counts[1], "max_abs_err": k1j["err"],
         "relu_edge_units": k1j["flips"], "ms": k1j_ms, "plain_ms": k1j_plain_ms,
         "bound_ms": k1j_bound, "bound_by": "operations", "library_ms": None},
        {"name": f"gather_fields (3 fields x {batch} ids, 5i's and 5j's steps)",
         "route": "cuda", "source": "mamdr_tpu_torch/csrc/gather_rows.cu",
         "replaces": "mamdr_tpu/ops/embedding_lookup.py:56",
         "launches": resume_counts[3] + learn_counts[3], "max_abs_err": k2_err,
         "ms": dn_t["k2"], "plain_ms": dn_t["plain"], "bound_ms": k2_bound,
         "bound_by": "bytes", "library_ms": dn_t["library"]},
        {"name": f"gather_fields (3 fields x {lanes * batch} ids, 5i's lanes and evals)",
         "route": "cuda", "source": "mamdr_tpu_torch/csrc/gather_rows.cu",
         "replaces": "mamdr_tpu/ops/embedding_lookup.py:56",
         "launches": resume_counts[4], "max_abs_err": k2l_err,
         "ms": dr_t["k2"], "plain_ms": dr_t["plain"], "bound_ms": k2l_bound,
         "bound_by": "bytes", "library_ms": dr_t["library"]},
        {"name": f"gather_fields (3 fields x {lanes_j * batch} ids, 5j's lanes and evals)",
         "route": "cuda", "source": "mamdr_tpu_torch/csrc/gather_rows.cu",
         "replaces": "mamdr_tpu/ops/embedding_lookup.py:56",
         "launches": learn_counts[4], "max_abs_err": k2j_err,
         "ms": j_t["k2"], "plain_ms": j_t["plain"], "bound_ms": k2j_bound,
         "bound_by": "bytes", "library_ms": j_t["library"]},
        # 5k-5m (TensorBoard, the DR lanes in groups with trainable tables,
        # bf16 towers and the per-leaf Adam, at bench shapes): K1 on the DN
        # steps of 5k's run, 5l's DN phase and 5m's two Adam runs (none in the
        # bf16 run: autograd); K1-lanes at 30 lanes on 5k's and 5m's DR and
        # finetune lane-steps and on 5l's one-group DR, at 7 lanes on 5l's
        # groups (timed and held at 7 lanes in 5l); K2 with ids [B] on those
        # DN steps, the bf16 run's autograd steps and _sample_grads, with ids
        # [L, B] on the lane-steps and evals of 5k and 5m over the shared
        # frozen tables, and on 5l's lane-steps over lane-stacked trainable
        # tables (timed and held at 7 and 30 lanes in 5l)
        {"name": "fused_tower_grad (5k's, 5l's and 5m's DN steps)", "route": "cuda",
         "source": "mamdr_tpu_torch/csrc/fused_mlp_step.cu",
         "replaces": "mamdr_tpu/ops/fused_mlp_step.py:141",
         "launches": tb_counts[0] + dn_l_counts[0] + flat_counts[0] + leaf_counts[0],
         "max_abs_err": k1_err, "relu_edge_units": k1_flips, "ms": k1_ms,
         "plain_ms": k1_plain_ms, "bound_ms": k1_bound, "bound_by": "operations",
         "library_ms": None},
        {"name": f"fused_tower_grad_lanes ({lanes} lanes, 5k's and 5m's lane-steps, 5l's "
                 "one-group DR)", "route": "cuda",
         "source": "mamdr_tpu_torch/csrc/fused_mlp_step.cu",
         "replaces": "mamdr_tpu/ops/fused_mlp_step.py:141",
         "launches": tb_counts[1] + dr30_counts[1] + flat_counts[1] + leaf_counts[1],
         "max_abs_err": k1l_err, "relu_edge_units": k1l_flips, "ms": k1l_ms,
         "plain_ms": k1l_plain_ms, "bound_ms": k1l_bound, "bound_by": "operations",
         "library_ms": None},
        {"name": f"fused_tower_grad_lanes ({lanes7} lanes, 5l's DR groups)", "route": "cuda",
         "source": "mamdr_tpu_torch/csrc/fused_mlp_step.cu",
         "replaces": "mamdr_tpu/ops/fused_mlp_step.py:141",
         "launches": dr7_counts[1], "max_abs_err": k1l7["err"],
         "relu_edge_units": k1l7["flips"], "ms": k1l7_ms, "plain_ms": k1l7_plain_ms,
         "bound_ms": k1l7_bound, "bound_by": "operations", "library_ms": None},
        {"name": f"gather_fields (3 fields x {batch} ids, 5k-5m's one-tower steps and "
                 "_sample_grads)", "route": "cuda",
         "source": "mamdr_tpu_torch/csrc/gather_rows.cu",
         "replaces": "mamdr_tpu/ops/embedding_lookup.py:56",
         "launches": (tb_counts[3] + dn_l_counts[3] + bf_counts[3] + flat_counts[3]
                      + leaf_counts[3]),
         "max_abs_err": k2_err, "bf16_step_rel_err": bf_step_rel,
         "ms": dn_t["k2"], "plain_ms": dn_t["plain"], "bound_ms": k2_bound,
         "bound_by": "bytes", "library_ms": dn_t["library"]},
        {"name": f"gather_fields (3 fields x {lanes * batch} ids, 5k's and 5m's lanes and "
                 "evals)", "route": "cuda",
         "source": "mamdr_tpu_torch/csrc/gather_rows.cu",
         "replaces": "mamdr_tpu/ops/embedding_lookup.py:56",
         "launches": tb_counts[4] + bf_counts[4] + flat_counts[4] + leaf_counts[4],
         "max_abs_err": k2l_err, "bf16_lane_step_rel_err": bf_lane_rel,
         "ms": dr_t["k2"], "plain_ms": dr_t["plain"], "bound_ms": k2l_bound,
         "bound_by": "bytes", "library_ms": dr_t["library"]},
        *[{"name": f"gather_fields (3 fields x {nl * batch} ids over lane-stacked trainable "
                   f"{nl}x{n_rows}x{dim} tables, 5l's "
                   f"{'DR groups' if nl == lanes7 else 'one-group DR'})",
           "route": "cuda", "source": "mamdr_tpu_torch/csrc/gather_rows.cu",
           "replaces": "mamdr_tpu/ops/embedding_lookup.py:56",
           "launches": (dr7_counts if nl == lanes7 else dr30_counts)[4],
           "max_abs_err": trained_k2[nl][0], "ms": trained_k2[nl][1]["k2"],
           "plain_ms": trained_k2[nl][1]["plain"], "bound_ms": trained_k2[nl][2],
           "bound_by": "bytes", "library_ms": trained_k2[nl][1]["library"]}
          for nl in (lanes7, d_l)],
        # 5n: K2 with row windows, on the (1, 2) mesh's ranks (each rank's
        # launches: the DN steps and the validation's one-tower calls with
        # ids [B], the DR lane-steps and the validation with ids [L, B])
        {"name": f"gather_fields with row windows (3 fields x {batch} ids, the (1, 2) mesh's "
                 "DN steps)", "route": "cuda", "source": "mamdr_tpu_torch/csrc/gather_rows.cu",
         "replaces": "mamdr_tpu/ops/embedding_lookup.py:56",
         "launches": win_one[0], "launches_per_rank": win_one, "max_abs_err": win_err,
         "ms": win_t["dn"]["k2"], "plain_ms": win_t["dn"]["plain"],
         "bound_ms": win_bound["dn"], "bound_by": "bytes",
         "library_ms": win_t["dn"]["library"]},
        {"name": f"gather_fields with row windows (3 fields x {lanes * batch} ids, the (1, 2) "
                 "mesh's DR lane-steps and validation)", "route": "cuda",
         "source": "mamdr_tpu_torch/csrc/gather_rows.cu",
         "replaces": "mamdr_tpu/ops/embedding_lookup.py:56",
         "launches": win_lane[0], "launches_per_rank": win_lane, "max_abs_err": win_err,
         "ms": win_t["dr"]["k2"], "plain_ms": win_t["dr"]["plain"],
         "bound_ms": win_bound["dr"], "bound_by": "bytes",
         "library_ms": win_t["dr"]["library"]},
        # K3's path is the gather probe, which runs it at both sizes: each
        # entry has the launches the probe counted at its depth and size, and
        # the error of its own comparison in 4b. At 1024 ids both depths plan
        # one and the same launch (a block owns fewer rows than either k).
        *[{"name": f"gather_rows_pipelined (k {k}, {batch} ids)", "route": "cuda",
           "source": "mamdr_tpu_torch/csrc/gather_rows_pipelined.cu",
           "replaces": "mamdr_tpu/ops/embedding_lookup.py:103",
           "launches": k3_launches[k, batch], "max_abs_err": k3_err[k, batch],
           "ms": k3_ms[k], "plain_ms": one_plain_ms, "bound_ms": one_bound,
           "bound_by": "bytes", "library_ms": one_lib_ms} for k in probe_gather.RING_DEPTHS],
        *[{"name": f"gather_rows_pipelined (k {k}, {lanes * batch} ids)", "route": "cuda",
           "source": "mamdr_tpu_torch/csrc/gather_rows_pipelined.cu",
           "replaces": "mamdr_tpu/ops/embedding_lookup.py:103",
           "launches": k3_launches[k, lanes * batch],
           "max_abs_err": k3_err[k, lanes * batch],
           "ms": k3l_ms[k], "plain_ms": one_l_plain_ms, "bound_ms": one_l_bound,
           "bound_by": "bytes", "library_ms": one_l_lib_ms} for k in probe_gather.RING_DEPTHS],
    ]}))
    # ---- 7. ----
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
