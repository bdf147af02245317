"""The multi-rank dry run, and the ranks of chip_smoke.py's phase 5n.

Counterpart of ``dryrun_multichip`` (``__graft_entry__.py:60-260``), on a
world that ``torchrun`` or the caller starts:

    torchrun --nproc-per-node 4 -m mamdr_tpu_torch.parallel.dryrun [--table 2]
    # CPU ranks: add --device cpu (gloo); ranks sharing one card: --backend gloo

runs its steps on the (data, table) mesh at tiny shapes, each asserting
finite results: (1) ``Trainer(mesh=)``'s ``fit_domain`` and
``evaluate_domain``, and a step of ``make_sharded_full_step`` on
``make_sharded_batch``; (1c) a fused MAMDR epoch (DN and DR) with the merged
validation; (1d) the DR lanes split over the data axis with frozen
row-sharded tables, one domain a data rank; (1e) the same with trainable
tables; (1f) MMoE with ``shard_experts``: its experts split over the table
axis, a ``fit_domain`` and the all-domain lane eval. Rank 0 prints one
JSON line of the results.

``--bench OUT`` runs the bench workload instead (``workload.py``: Taobao-30
shapes, ``mlp_meta_mamdr_finetune``) on the mesh: the fused epoch's DN and
DR phases and the merged validation, each with its kernel launch counts,
and with ``--run`` a whole ``run()`` after them; rank 0 writes the whole
shared weights, specific stack, state, results and counts to ``OUT`` (npz)
for the caller to hold against one device. The one-device reference
(``--one-device``) also writes the state the DR phase starts from to
``OUT.dn.npz`` as soon as its DN phase ends; ranks given ``--dr-from REF``
wait for ``REF.dn.npz`` after their own DN phase and run the DR phase and
the validation from it, so that those two phases can be held to one
device's where the DN phase's sums differ in order (a data axis).
Checkpoints go to ``--checkpoint-dir`` (default ``OUT.ckpt``, shared by
the ranks; rank 0 writes). ``--deterministic`` turns on
``torch.use_deterministic_algorithms`` before the first CUDA call.

``--resume-run OUT`` (before ``--bench`` when both are given) runs the bench
workload's ``run()`` of 2 epochs with the resume snapshot after every epoch
and TensorBoard's weight and gradient histograms at every validation;
``--snapshot-to CKPT`` copies its first snapshot (after epoch 1) to where a
run with checkpoint root ``CKPT`` looks for one, as a run stopped there
would have left it. ``--resumed-run OUT`` is that run on fresh ranks,
resumed from the snapshot in its own checkpoint root (``OUT.ckpt``), which
it waits for. Both write what ``bench_resume`` says.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from mamdr_tpu_torch.parallel.mesh import init_distributed, make_mesh, shutdown


def _tiny_config(name: str, seed: int, ckpt: str, **train):
    from mamdr_tpu_torch.config import ExperimentConfig

    return ExperimentConfig.from_dict({
        "model": {"name": name, "user_dim": 32, "item_dim": 32, "domain_dim": 32,
                  "hidden_dim": [64, 32], "dropout": 0.5},
        "train": {"learning_rate": 1e-3, "meta_learning_rate": 0.1, "sample_num": 2,
                  "add_query_domain": True, "metrics_jsonl": False,
                  "sharded_lookup_min_rows": 16,
                  "checkpoint_path": ckpt,
                  **train},
        "dataset": {"name": "synthetic", "batch_size": 64, "seed": seed}})


def dryrun(mesh, ckpt: str) -> dict:
    """Steps 1, 1c, 1d, 1e and 1f on ``mesh``, checkpoints under ``ckpt``;
    returns their finite results."""
    from mamdr_tpu_torch.data.synthetic import make_synthetic_dataset
    from mamdr_tpu_torch.parallel.trainer_sharding import make_sharded_batch, make_sharded_full_step
    from mamdr_tpu_torch.strategies.mamdr import MAMDRStrategy
    from mamdr_tpu_torch.train.trainer import Trainer

    n_uid = n_pid = 64 * mesh.table
    out = {}

    def finite(what, *vals):
        if not all(np.isfinite(v) for v in vals):
            raise AssertionError(f"{what}: non-finite {vals}")

    def sharded(t):
        emb = t.shard_axes["model"]["embedding"]
        if not (emb["user_emb"] and emb["item_emb"]):
            raise AssertionError("the user and item tables are not row-sharded")

    ds = make_synthetic_dataset(n_domain=4, n_uid=n_uid, n_pid=n_pid, n_per_domain=256,
                                seed=0, batch_size=64)
    t = Trainer(_tiny_config("mlp", 0, ckpt), ds, verbose=False, mesh=mesh)
    sharded(t)
    t.state, loss = t.fit_domain(t.state, 0)
    l, a = t.evaluate_domain("val", 0, t.state.params, t.state.batch_stats)
    step, state = make_sharded_full_step(t)
    _, step_loss = step(state, make_sharded_batch(mesh, n_uid, n_pid, 4, 64))
    finite("1: fit_domain / evaluate_domain / a full step", float(loss), l, a,
           float(step_loss))
    out["1"] = {"loss": float(loss), "val_loss": l, "val_auc": a,
                "full_step_loss": float(step_loss)}

    def mamdr(step, dataset, **train):
        tm = Trainer(_tiny_config("mlp_meta_mamdr", dataset.seed, ckpt, **train), dataset,
                     verbose=False, mesh=mesh)
        sharded(tm)
        s = MAMDRStrategy(tm)
        s.prepare_fused()
        losses = s.run_fused_epoch()
        _, auc, _, _ = s._merged_eval("val", s.shared, s.specific)
        finite(step, *losses, auc)
        out[step] = {"dr_lanes": bool(s.dr_lanes), "dn_losses": [float(v) for v in losses],
                     "val_auc": auc}
        return s

    mamdr("1c", ds)
    for step, seed, trainable in (("1d", 0, False), ("1e", 1, True)):
        dsl = make_synthetic_dataset(n_domain=mesh.data, n_uid=n_uid, n_pid=n_pid,
                                     n_per_domain=128, seed=seed, batch_size=64)
        s = mamdr(step, dsl, sample_num=1, emb_trainable=trainable, dr_parallel="on")
        if not s.dr_lanes:
            raise AssertionError(f"{step}: the DR phase did not take the lanes")
    cfg = _tiny_config("mmoe", 0, ckpt, shard_experts=True)
    cfg.model.num_experts = 4
    te = Trainer(cfg, ds, verbose=False, mesh=mesh)
    held = te.state.params["model"]["experts"]["expert_kernel_0"].shape[0]
    if held * mesh.table != 4:
        raise AssertionError(f"1f: a rank holds {held} of 4 experts on a table axis of "
                             f"{mesh.table}")
    te.state, loss = te.fit_domain(te.state, 0)
    _, auc, _, _ = te.val_and_test("val")
    finite("1f: MMoE with shard_experts", float(loss), auc)
    out["1f"] = {"experts_held": held, "loss": float(loss), "val_auc": auc}
    return out


def _dr_start(t, s):
    """What the DR phase starts from, frozen tables left out (they never
    move): the state and the shared weights (``_save_dr_start`` adds the
    device generator's state, which the loading rank checks)."""
    frozen = {n for n, f in _names(t.frozen_mask()) if f}

    def keep(tree):
        return {n: x for n, x in _names(tree) if n not in frozen}

    out = {"params/" + n: x for n, x in keep(t.state.params).items()}
    out.update({"shared/" + n: x for n, x in keep(s.shared).items()})
    out.update({f"opt/{i}": x for i, x in enumerate(t.state.opt_state)})
    out["step"] = t.state.step
    return out


def _names(tree):
    from mamdr_tpu_torch.utils import trees

    return trees.leaves_with_names(tree)


def _save_dr_start(t, s, path: str) -> None:
    from mamdr_tpu_torch.train.checkpoints import _write_npz

    flat = {k: x.detach().cpu().numpy() for k, x in _dr_start(t, s).items()}
    flat["gen"] = t.gen.get_state().numpy()
    _write_npz(path, flat)


def _load_dr_start(t, s, path: str, timeout: float = 900.0) -> None:
    """Wait for ``path`` (written whole by a rename), check that this rank's
    generator drew what the writer's did, and put its state, shared weights
    and optimizer slots in place of this rank's."""
    from mamdr_tpu_torch.utils import trees

    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path} after {timeout} s")
        time.sleep(0.2)
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    if not np.array_equal(flat.pop("gen"), t.gen.get_state().numpy()):
        raise AssertionError("the DN phase left the device generator elsewhere than the "
                             "reference's")
    mine = _dr_start(t, s)
    if sorted(mine) != sorted(flat):
        raise AssertionError(f"the DR start holds {sorted(flat)[:4]}..., this rank "
                             f"{sorted(mine)[:4]}...")

    def like(key, x):
        v = flat[key]
        if tuple(v.shape) != tuple(x.shape):  # a rank's slice is not the whole
            raise ValueError(f"{key}: {v.shape} in the DR start, {tuple(x.shape)} here")
        return torch.from_numpy(v).to(x.device, x.dtype)

    def put(prefix):
        return lambda n, x: like(prefix + n, x) if prefix + n in flat else x

    opt = t.state.opt_state
    t.state = t.state.replace(
        params=trees.named_tree_map(put("params/"), t.state.params),
        opt_state=type(opt)(*(like(f"opt/{i}", x) for i, x in enumerate(opt))),
        step=like("step", t.state.step))
    s.shared = trees.named_tree_map(put("shared/"), s.shared)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(device, fn):
    """(fn(), its seconds, the kernel launches it made: K1, K1-lanes, K2, K2
    with ids [L, B], K2 with a row window), the card synchronised at both
    ends."""
    from mamdr_tpu_torch.ops.embedding_lookup import gather_fields
    from mamdr_tpu_torch.ops.fused_mlp_step import fused_tower_grad, fused_tower_grad_lanes

    _sync(device)
    fused_tower_grad.launches = fused_tower_grad_lanes.launches = 0
    gather_fields.launches = gather_fields.lane_launches = gather_fields.window_launches = 0
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0, [
        fused_tower_grad.launches, fused_tower_grad_lanes.launches, gather_fields.launches,
        gather_fields.lane_launches, gather_fields.window_launches]


def bench(mesh, out_path: str, run: bool, device=None, ckpt=None, dr_from=None) -> None:
    """The bench workload's fused epoch (DN, then DR) and merged validation
    and, with ``run``, a whole ``run()`` on a fresh trainer, on ``mesh`` (None:
    one device, the reference the ranks are held to). Every rank writes
    ``OUT.rank<r>.json``: seconds and kernel launch counts of each phase
    (K1, K1-lanes, K2, K2 with ids [L, B], K2 with a row window); rank 0
    writes ``OUT`` (npz): one train step's loss and Adam slots from the
    initial state on domain 0's first rows, the DN losses, the validation's per-domain losses
    and AUCs, the whole shared weights, specific stack, state params and
    Adam slots (``mu`` over the rank's leaves), and the run's results and
    whole best params. One device writes ``OUT.dn.npz`` after its DN phase;
    with ``dr_from`` the DR phase and the validation start from
    ``dr_from + ".dn.npz"`` instead of this run's DN phase. Checkpoints go
    to ``ckpt`` (default ``OUT.ckpt``)."""
    from mamdr_tpu_torch.strategies.mamdr import MAMDRStrategy
    from mamdr_tpu_torch.train.checkpoints import _flatten
    from mamdr_tpu_torch.train.trainer import Trainer
    from mamdr_tpu_torch.utils import trees
    from mamdr_tpu_torch.workload import bench_config, bench_dataset

    device = torch.device(device or "cuda") if mesh is None else mesh.device
    timed = functools.partial(_timed, device)

    ds = bench_dataset()
    cfg = bench_config(checkpoint_path=ckpt or out_path + ".ckpt")
    cfg.train.metrics_jsonl = False
    res = {}
    t0 = time.perf_counter()
    t = Trainer(cfg, ds, device=device, verbose=False, mesh=mesh)
    s = MAMDRStrategy(t)
    s.prepare_fused()
    res["setup_s"] = time.perf_counter() - t0
    # one train step from the initial state on domain 0's first rows (the
    # state is not kept): where the mesh changes the sums' order, a check of
    # the step itself
    first = {k: v[0, :cfg.dataset.batch_size] for k, v in t.train_block()[0].items()}
    stepped, step_loss = t.train_step_fn()(t.state, first)
    arrays = {"step_loss": step_loss.reshape(1).cpu().numpy(),
              "step_mu": stepped.opt_state.mu.cpu().numpy(),
              "step_nu": stepped.opt_state.nu.cpu().numpy()}
    del stepped
    losses, res["dn_s"], res["dn_counts"] = timed(s.run_dn_phase)
    if mesh is None:
        _save_dr_start(t, s, out_path + ".dn.npz")
    if dr_from:
        _load_dr_start(t, s, dr_from + ".dn.npz")
    _, res["dr_s"], res["dr_counts"] = timed(s.run_dr_phase)
    val, res["val_s"], res["val_counts"] = timed(s.validate)
    res["dr_lanes"] = bool(s.dr_lanes)
    doms = [str(d) for d in range(s.n_domain)]
    frozen = t.frozen_mask()

    def whole(tree):  # frozen tables never move: left out
        return _flatten(t.whole(trees.tree_map(
            lambda f, x: x.new_zeros(()) if f else x, frozen, tree)))

    arrays.update({"dn_losses": np.asarray(losses),
                   "val_loss": np.asarray([val[2][d] for d in doms]),
                   "val_auc": np.asarray([val[3][d] for d in doms]),
                   "mu": t.state.opt_state.mu.cpu().numpy()})
    for prefix, tree in (("shared/", s.shared), ("spec/", s._spec_stack),
                         ("state/", t.state.params)):
        arrays.update({prefix + k: v for k, v in whole(tree).items() if v.ndim})
    if run:
        del s
        t = Trainer(cfg, ds, device=device, verbose=False, mesh=mesh)
        s = MAMDRStrategy(t)
        r, res["run_s"], res["run_counts"] = timed(s.run)
        arrays["run_loss"] = np.asarray([r[2][d] for d in doms])
        arrays["run_auc"] = np.asarray([r[3][d] for d in doms])
        arrays.update({"best/" + k: v for k, v in whole(t.best_params).items() if v.ndim})
    rank = 0 if mesh is None else mesh.rank
    with open(f"{out_path}.rank{rank}.json", "w") as f:
        json.dump(res, f)
    if rank == 0:
        np.savez(out_path, **arrays)


def bench_resume(mesh, out_path: str, resumed: bool = False, device=None,
                 snapshot_to=None, timeout: float = 900.0) -> None:
    """The bench workload's ``run()`` of 2 epochs with the resume snapshot
    after every epoch and TensorBoard (weight and gradient histograms every
    validation) on ``mesh`` (None: one device), its checkpoints under
    ``OUT.ckpt``: unbroken, its first snapshot copied to ``snapshot_to``'s
    resume folder when given; or (``resumed``) resumed from the snapshot in
    its own resume folder, which it waits for. Every rank writes
    ``OUT.rank<r>.json``: the run's seconds and kernel launch counts (as
    ``bench``), the snapshots' seconds and bytes, the TensorBoard work's
    seconds, the epoch the run started at and ``try_resume``'s seconds, the
    event folder, and the step counts the launches follow from; rank 0
    writes ``OUT`` (npz): the test losses and AUCs, the whole shared
    weights, specific stack, state params, Adam slots and best snapshot
    (shared and the specific stack; frozen tables left out)."""
    from mamdr_tpu_torch.parallel.trainer_sharding import whole_train_state
    from mamdr_tpu_torch.strategies.mamdr import MAMDRStrategy
    from mamdr_tpu_torch.train import fused
    from mamdr_tpu_torch.train.checkpoints import _flatten
    from mamdr_tpu_torch.train.trainer import Trainer
    from mamdr_tpu_torch.utils import trees
    from mamdr_tpu_torch.workload import bench_config, bench_dataset

    device = torch.device(device or "cuda") if mesh is None else mesh.device
    rank = 0 if mesh is None else mesh.rank

    def sync():
        _sync(device)

    ckpt = out_path + ".ckpt"
    cfg = bench_config(checkpoint_path=ckpt)
    tc = cfg.train
    tc.metrics_jsonl = False
    tc.epoch, tc.tensorboard, tc.histogram_freq, tc.write_grads = 2, True, 1, True
    tc.resume, tc.resume_every = resumed, 0 if resumed else 1
    t = Trainer(cfg, bench_dataset(), device=device, verbose=False, mesh=mesh)
    s = MAMDRStrategy(t)
    res = {"snapshot_s": [], "tb_s": 0.0, "tb_calls": 0,
           "logdir": os.path.join(t.checkpoint_dir, "tensorboard")}

    save = t.save_resume_state

    def timed_save(*a, **k):
        sync()
        t0 = time.perf_counter()
        save(*a, **k)
        res["snapshot_s"].append(time.perf_counter() - t0)
        if len(res["snapshot_s"]) == 1:
            res["snapshot_bytes"] = {f: os.path.getsize(os.path.join(t.resume_dir, f))
                                     for f in sorted(os.listdir(t.resume_dir))}
            if snapshot_to and rank == 0:
                dst = os.path.join(snapshot_to, os.path.relpath(t.resume_dir, ckpt))
                shutil.copytree(t.resume_dir, dst + ".part")
                os.rename(dst + ".part", dst)  # the folder appears whole

    t.save_resume_state = timed_save

    def timed_tb(fn):
        def wrapped(*a, **k):
            sync()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            sync()
            res["tb_s"] += time.perf_counter() - t0
            res["tb_calls"] += 1
            return out
        return wrapped

    for name in ("log_eval", "log_histograms", "log_grad_histograms"):
        setattr(t.tb, name, timed_tb(getattr(t.tb, name)))
    t._sample_grads = timed_tb(t._sample_grads)
    try_resume = t.try_resume

    def timed_resume(*a, **k):
        t0 = time.perf_counter()
        r = try_resume(*a, **k)
        res["resume_s"], res["started"] = time.perf_counter() - t0, None if r is None else r[0]
        return r

    t.try_resume = timed_resume
    if resumed:
        deadline = time.monotonic() + timeout
        while not os.path.exists(os.path.join(t.resume_dir, "resume_meta.json")):
            if time.monotonic() > deadline:
                raise TimeoutError(f"no snapshot in {t.resume_dir} after {timeout} s")
            time.sleep(0.2)
    r, res["run_s"], res["run_counts"] = _timed(device, s.run)
    t.tb.close()
    res["steps"] = {"per_domain": t.steps_per_domain(),
                    "val": max(t.eval_steps_per_domain("val")),
                    "test": max(t.eval_steps_per_domain("test")),
                    "k": min(tc.sample_num, t.dataset.n_domain - 1) + int(tc.add_query_domain),
                    "cap": tc.domain_regulation_step, "epochs": tc.epoch}
    frozen = t.frozen_mask()

    def whole(tree):  # frozen tables never move: left out
        return _flatten(t.whole(trees.tree_map(
            lambda f, x: x.new_zeros(()) if f else x, frozen, tree)))

    opt = (t.state.opt_state if mesh is None
           else whole_train_state(t.state, t.shard_axes, mesh, t.tx).opt_state)
    doms = [str(d) for d in range(s.n_domain)]
    arrays = {"run_loss": np.asarray([r[2][d] for d in doms]),
              "run_auc": np.asarray([r[3][d] for d in doms]),
              "mu": opt.mu.cpu().numpy(), "nu": opt.nu.cpu().numpy()}
    best_spec = fused.stack_specific(s.best_specific, s.mask)
    for prefix, tree in (("shared/", s.shared), ("spec/", s._spec_stack),
                         ("state/", t.state.params), ("best_shared/", s.best_shared),
                         ("best_spec/", best_spec)):
        arrays.update({prefix + k: v for k, v in whole(tree).items() if v.ndim})
    with open(f"{out_path}.rank{rank}.json", "w") as f:
        json.dump(res, f)
    if rank == 0:
        np.savez(out_path, **arrays)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--table", type=int, default=None, help="table-axis size")
    p.add_argument("--device", default=None, help="cpu, or the rank's card by default")
    p.add_argument("--backend", default=None, help="gloo or nccl (default by device)")
    p.add_argument("--init-method", default=None, help="default env:// (torchrun)")
    p.add_argument("--bench", default=None, metavar="OUT", help="run the bench workload")
    p.add_argument("--run", action="store_true", help="with --bench: a whole run() too")
    p.add_argument("--deterministic", action="store_true")
    p.add_argument("--one-device", action="store_true",
                   help="with --bench: no process group, the reference on one device")
    p.add_argument("--dr-from", default=None, metavar="REF",
                   help="with --bench: the DR phase and the validation start from the "
                        "one-device reference's REF.dn.npz")
    p.add_argument("--resume-run", default=None, metavar="OUT",
                   help="(before --bench) the bench run() of 2 epochs with the resume "
                        "snapshot and TensorBoard")
    p.add_argument("--snapshot-to", default=None, metavar="CKPT",
                   help="with --resume-run: copy its first snapshot to checkpoint root CKPT")
    p.add_argument("--resumed-run", default=None, metavar="OUT",
                   help="that run resumed from the snapshot in OUT.ckpt (waited for)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="checkpoints (default: OUT.ckpt with --bench, else a folder in "
                        "the temporary directory)")
    a = p.parse_args()
    if a.deterministic:  # before the first CUDA call
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True, warn_only=True)
    if a.one_device:
        if not (a.bench or a.resume_run):
            raise SystemExit("--one-device goes with --bench or --resume-run")
        if a.resume_run:
            bench_resume(None, a.resume_run, device=a.device)
        if a.bench:
            bench(None, a.bench, a.run, a.device, a.checkpoint_dir)
        return 0
    dev = init_distributed(a.backend, a.device, a.init_method)
    mesh = make_mesh(table_parallelism=a.table, device=dev)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    if a.bench or a.resume_run or a.resumed_run:
        if a.resume_run:
            bench_resume(mesh, a.resume_run, snapshot_to=a.snapshot_to)
        if a.bench:
            bench(mesh, a.bench, a.run, ckpt=a.checkpoint_dir, dr_from=a.dr_from)
        if a.resumed_run:
            bench_resume(mesh, a.resumed_run, resumed=True)
    else:
        out = dryrun(mesh, a.checkpoint_dir
                     or os.path.join(tempfile.gettempdir(), "mamdr_dryrun"))
        if mesh.rank == 0:
            print(json.dumps({"mesh": mesh.shape, **out}))
    shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
