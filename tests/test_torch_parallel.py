"""The port's (data, table) mesh on real gloo ranks vs the JAX package's mesh.

Four CPU ranks (``torch.distributed`` over gloo, one file store a layout)
are started once for this module by the ``ranks`` fixture; they run the
cases below in this file's ``__main__`` (no JAX there) and write their
results next to the inputs the JAX side wrote. The JAX side runs in the
pytest process on the 8-device CPU mesh of ``tests/conftest.py``, while the
ranks work:

- ``mesh_shape`` against the JAX ``make_mesh`` for 1-8 devices; ``pad_rows``,
  ``process_local_rows`` and (on the ranks) ``shard_host_batch``;
  ``param_sharding_specs`` against the JAX rule for mlp, mmoe, ple, the
  wide term's dim-1 tables (wdl, deepfm) and STAR's top-level tables;
- ``sharded_lookup`` on meshes (1, 4) and (2, 2): in-range ids bit-equal to
  the plain gather, zeros where the JAX sharded lookup gives zeros (ids
  outside [0, rows)), and the table-shard gradients (summed over the data
  group) against ``jax.grad`` of the JAX ``sharded_lookup``;
- ``Trainer(mesh=)``'s ``fit_domain`` / ``evaluate_domain`` on (2, 2) against
  the JAX ``Trainer(mesh=make_mesh(jax.devices()[:4], table_parallelism=2))``
  on ``test_mesh_trainer.py``'s recipe, the JAX init carried across
  (``convert.state_on_mesh``): rtol 2e-5, atol 1e-5 (gradients summed in
  another order through Adam);
- a whole joint ``run()`` on the mesh, its best-params file read by the JAX
  ``load_pytree`` at the padded shapes and equal to the ranks' whole tree,
  and by ``Trainer.load_checkpoint`` into each rank's rows; a whole MAMDR
  ``run()``, its decomposition read by the JAX ``load_decomposition``;
- a dropout-0.5 epoch on (2, 2) against the port's single-process epoch:
  the data ranks' masks are one device's (seeds shifted by a rank's first
  row), so only the summation order differs — within 1e-4 of each leaf's
  largest value;
- ``make_sharded_train_step`` against the JAX one from the JAX init;
- the resume snapshot on (2, 2): joint, DN and MAML resumed on the mesh
  against the JAX package's resumed mesh run (``test_torch_resume.py``'s
  recipe, the JAX init carried across; rtol 2e-5, atol 1e-5), and the
  joint snapshot read by the JAX ``load_pytree`` with the JAX mesh
  trainer's templates;
- TensorBoard on (2, 2): ``summarize``'s event files against the JAX mesh
  trainer's, rank 0 the only writer;
- ``shard_experts`` on MMoE and PLE (``tests/test_expert_parallel.py``'s
  recipe, four domains so PLE's task experts split over the table axis):
  three data-parallel steps, a lane step and a lane eval (the collectives
  under ``torch.func.vmap``) on (2, 2) against the port's one process, and
  PLE's ``ple.expert_rows`` / ``_used`` over the first step: a rank's
  slice computes its held tasks' experts of every level (held·t + s a
  level), whole leaves the last level for the batch's task alone
  (losses and evaluations rtol 2e-5 / atol 2e-5, params with a floor of
  lr/100 for Adam's steps on rounding-noise gradients), and the one
  process's losses and first-step Adam slots against the JAX
  expert-sharded run.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASE_SECONDS = 60  # a case's own time limit on a rank, unless its file names another
START_SECONDS = 30  # a rank's imports and process group before its first case

TRAINER_CFG = {  # tests/test_mesh_trainer.py's recipe
    "model": {"name": "mlp", "user_dim": 8, "item_dim": 8, "domain_dim": 8,
              "hidden_dim": [16, 8], "dropout": 0.0},
    "train": {"epoch": 2, "learning_rate": 0.01, "patience": 3, "metrics_jsonl": False,
              "sharded_lookup_min_rows": 16},
    "dataset": {"name": "synthetic", "batch_size": 64, "seed": 31},
}
TRAINER_DS = dict(n_domain=2, n_uid=64, n_pid=64, n_per_domain=500, seed=31, batch_size=64)
LOOKUP_IDS = np.asarray([3, 63, -3, 64, 70, 1000, 17, 40, 0, 5, 33, 62, 2**31 - 1, 31, 32, 9],
                        np.int32)
TRAIN_STEP = dict(n_uid=64, n_pid=64, n_domain=4, batch=64, hidden=(16, 8), dim=8,
                  learning_rate=1e-2)


TB_LOSS = {"0": 0.61, "1": 0.65}  # the evaluations summarize() is handed
TB_AUC = {"0": 0.55, "1": 0.6123456789}
TB_TRAIN = {"histogram_freq": 1, "write_grads": True}
TB_MODES = ("val", "test")
# tests/test_torch_resume.py's routes that resume, on the trainer recipe
# above cut to one batch a domain (the fused passes' shuffles, threefry and
# torch, then permute the same rows)
RESUME_ROUTES = {
    "joint_fused": ("mlp", {}),
    "dn": ("mlp_meta_domain_negotiation_finetune", {}),
    "maml": ("mlp_meta_maml_finetune", {"meta_split": "meta-train/val",
                                        "meta_split_ratio": 0.5}),
}
RESUME_DS = {**TRAINER_DS, "n_per_domain": 100}


def trainer_config(tag, root, train=None, **model):
    d = json.loads(json.dumps(TRAINER_CFG))
    d["model"].update(model)
    d["train"].update(checkpoint_path=os.path.join(root, f"c{tag}"),
                      result_save_path=os.path.join(root, f"r{tag}"), **(train or {}))
    return d


def resume_config(route, root, side, epoch, **train):
    name, extra = RESUME_ROUTES[route]
    d = trainer_config(f"{side}_{route}", os.path.join(root, side), dict(
        epoch=epoch, patience=2, meta_learning_rate=0.05, sample_num=2, **extra, **train),
        name=name)
    return d


def case_seconds(name, seconds=None):
    return (seconds or {}).get(name, CASE_SECONDS)


def launch(script, root, world, cases, seconds=None):
    """Start ``world`` gloo ranks of ``script``'s ``__main__`` on ``cases``;
    returns a function that waits for them and fails on any rank's error.
    The ranks have the cases' time limits (``seconds``, else
    ``CASE_SECONDS`` each) together, after ``START_SECONDS``."""
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    init = f"file://{os.path.join(root, 'store')}"
    deadline = time.monotonic() + START_SECONDS + sum(case_seconds(c, seconds) for c in cases)
    procs = []
    for r in range(world):
        log = open(os.path.join(root, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, script, str(r), str(world), init, root, *cases],
            env=env, stdout=log, stderr=subprocess.STDOUT), log))

    def wait():
        for r, (p, log) in enumerate(procs):
            try:
                rc = p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                for q, _ in procs:
                    q.kill()
                rc = "timeout"
            log.close()
            if rc != 0:
                with open(os.path.join(root, f"rank{r}.log")) as f:
                    raise AssertionError(f"rank {r} ended with {rc}:\n{f.read()[-4000:]}")
        return root

    return wait


def rank_main(cases_of, seconds=None):
    """A rank's ``__main__``: join the file store's group on the CPU, run the
    named cases, each within its time limit (``case_seconds``: past it the
    rank raises, naming the case), leave the group."""
    rank, world, init, root, *cases = sys.argv[1:]
    os.environ.update(RANK=rank, WORLD_SIZE=world, LOCAL_RANK="0")
    torch.set_num_threads(1)
    from mamdr_tpu_torch.parallel.mesh import init_distributed, shutdown

    init_distributed(device="cpu", init_method=init)
    inputs = dict(np.load(os.path.join(root, "inputs.npz"), allow_pickle=True))
    for name in cases:
        limit = case_seconds(name, seconds)

        def late(*_, name=name, limit=limit):
            raise TimeoutError(f"case {name} ran past its {limit} s")

        signal.signal(signal.SIGALRM, late)
        signal.alarm(limit)
        t0 = time.monotonic()
        try:
            cases_of[name](root, inputs)
        finally:
            signal.alarm(0)
        print(f"case {name}: {time.monotonic() - t0:.1f} s", flush=True)
    shutdown()


def save(root, name, **arrays):
    np.savez(os.path.join(root, f"{name}.npz"), **arrays)


def flat_whole(prefix, tree):
    from mamdr_tpu_torch.train.checkpoints import _flatten

    return {f"{prefix}{k}": v for k, v in _flatten(tree).items()}


# ---------------- the ranks' cases (no JAX) ----------------

def case_lookup(root, inputs):
    from mamdr_tpu_torch.parallel.data_feed import data_rows, shard_host_batch
    from mamdr_tpu_torch.parallel.embedding_shard import shard_range, sharded_lookup
    from mamdr_tpu_torch.parallel.mesh import (
        DATA_AXIS, TABLE_AXIS, all_gather_dim0, all_reduce_sum, make_mesh)

    table, ct = torch.from_numpy(inputs["lookup_table"]), torch.from_numpy(inputs["lookup_ct"])
    ids = torch.from_numpy(LOOKUP_IDS)
    for t in (4, 2):
        mesh = make_mesh(table_parallelism=t, device="cpu")
        rows = data_rows(mesh, ids.shape[0])
        shard = table[shard_range(mesh, table.shape[0])].clone().requires_grad_(True)
        out = sharded_lookup(mesh, shard, ids[rows])
        (g,) = torch.autograd.grad(torch.sum(out * ct[rows]), shard)
        g = all_reduce_sum(mesh, g, DATA_AXIS)  # the step's sum over the data group
        out = all_gather_dim0(mesh, out.detach(), DATA_AXIS)
        g = all_gather_dim0(mesh, g, TABLE_AXIS)
        host = shard_host_batch(mesh, {"uid": LOOKUP_IDS})["uid"]  # this data rank's rows
        assert torch.equal(host, ids[rows]) and host.shape[0] == 16 // mesh.data
        if mesh.rank == 0:
            save(root, f"lookup_{mesh.data}x{mesh.table}", out=out.numpy(), grad=g.numpy())


def _mesh22():
    from mamdr_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(table_parallelism=2, device="cpu")


def _mesh_trainer(mesh, root, tag, inputs, train=None, **model):
    from mamdr_tpu_torch.config import ExperimentConfig
    from mamdr_tpu_torch.convert import state_on_mesh
    from mamdr_tpu_torch.data.synthetic import make_synthetic_dataset
    from mamdr_tpu_torch.train.trainer import Trainer
    from mamdr_tpu_torch.utils import trees

    cfg = ExperimentConfig.from_dict(trainer_config(tag, root, train, **model))
    t = Trainer(cfg, make_synthetic_dataset(**TRAINER_DS), verbose=False, mesh=mesh)
    whole = trees.unflatten({k[len("init/"):].replace("//", "/"): v
                             for k, v in inputs.items() if k.startswith("init/")})
    params, axes = state_on_mesh(whole, mesh, min_rows=16)
    assert trees.leaves(axes) == trees.leaves(t.shard_axes)
    t.state = t.state.replace(params=params, opt_state=t.tx.init(params))
    return t


def case_trainer(root, inputs):
    mesh = _mesh22()
    t = _mesh_trainer(mesh, root, "fit", inputs)
    assert t.state.params["model"]["embedding"]["user_emb"].shape == (32, 8)
    t.state, loss = t.fit_domain(t.state, 0)
    l, a = t.evaluate_domain("val", 0, t.state.params, t.state.batch_stats)
    whole = t.whole(t.state.params)
    if mesh.rank == 0:
        save(root, "trainer", loss=float(loss), val=np.asarray([l, a]),
             **flat_whole("p/", whole))


def case_joint_run(root, inputs):
    from mamdr_tpu_torch.strategies.base import build_strategy

    mesh = _mesh22()
    t = _mesh_trainer(mesh, root, "run", inputs)
    avg_loss, avg_auc, dloss, dauc = build_strategy(t).run()
    t.save_result(avg_loss, avg_auc, dloss, dauc)
    loaded = t.load_checkpoint()  # the whole file read, this rank's rows kept
    for a, b in zip(trees_leaves(loaded), trees_leaves(t.best_params)):
        assert torch.equal(a, b)
    whole = t.whole(t.best_params)
    if mesh.rank == 0:
        save(root, "joint_run", avg=np.asarray([avg_loss, avg_auc]),
             path=t.checkpoint_path, n_domain=len(dauc), **flat_whole("p/", whole))


def trees_leaves(tree):
    from mamdr_tpu_torch.utils import trees
    return trees.leaves(tree)


def case_mamdr_run(root, inputs):
    """A whole MAMDR run() on (2, 2) with trainable tables: its
    decomposition written once, whole, for the JAX ``load_decomposition``."""
    from mamdr_tpu_torch.config import ExperimentConfig
    from mamdr_tpu_torch.data.synthetic import make_synthetic_dataset
    from mamdr_tpu_torch.strategies.mamdr import MAMDRStrategy
    from mamdr_tpu_torch.train.trainer import Trainer

    mesh = _mesh22()
    d = trainer_config("mamdr", root, name="mlp_meta_mamdr_finetune")
    d["train"].update(epoch=1, sample_num=1)
    t = Trainer(ExperimentConfig.from_dict(d), make_synthetic_dataset(**TRAINER_DS),
                verbose=False, mesh=mesh)
    s = MAMDRStrategy(t)
    res = s.run()
    shared = t.whole(s.best_shared)
    spec = [t.whole(x) for x in s.best_specific]
    if mesh.rank == 0:
        save(root, "mamdr_run", dir=t.checkpoint_dir + "/decomposition",
             dauc=np.asarray([res[3][k] for k in sorted(res[3])]),
             **flat_whole("shared/", shared), **flat_whole("spec0/", spec[0]))


def case_dropout(root, inputs):
    mesh = _mesh22()
    t = _mesh_trainer(mesh, root, "drop", inputs, dropout=0.5)
    t.state, loss = t.fit_domain(t.state, 0)
    whole = t.whole(t.state.params)
    if mesh.rank == 0:
        save(root, "dropout", loss=float(loss), **flat_whole("p/", whole))


def case_sharded_train(root, inputs):
    from mamdr_tpu_torch.parallel.sharded_train import make_sharded_train_step
    from mamdr_tpu_torch.utils import trees

    mesh = _mesh22()
    whole = trees.unflatten({k[len("st/"):].replace("//", "/"): v
                             for k, v in inputs.items() if k.startswith("st/")})
    step, state, batch = make_sharded_train_step(mesh, params=whole, **TRAIN_STEP)
    losses = []
    for _ in range(3):
        state, loss = step(state, batch)
        losses.append(float(loss))
    from mamdr_tpu_torch.parallel.mesh import TABLE_AXIS, all_gather_dim0
    p = dict(state.params)
    for k in ("user_emb", "item_emb"):
        p[k] = all_gather_dim0(mesh, p[k], TABLE_AXIS)
    if mesh.rank == 0:
        save(root, "sharded_train", losses=np.asarray(losses), **flat_whole("p/", p))


def slots_whole(t, vec, tx):
    """A flat Adam slot vector over a rank's leaves -> the whole tree's flat
    one, leaf by leaf through ``Trainer.whole`` (not the flat path the
    snapshot takes)."""
    from mamdr_tpu_torch.utils import trees

    sel = [x for x, m in zip(trees.leaves(t.state.params), tx._trainable) if m]
    pieces = iter(torch.split(vec, [x.numel() for x in sel]))
    tree = trees.tree_map(lambda m, x: next(pieces).reshape(x.shape) if m else x.new_zeros(()),
                          tx.mask, t.state.params)
    return torch.cat([x.reshape(-1) for x, m in zip(trees.leaves(t.whole(tree)), tx._trainable)
                      if m]).numpy()


def hold_snapshots(t, held, copy_to=None):
    """Wrap ``t.save_resume_state``: after the first snapshot ``held`` holds
    the whole trees the ranks hold, keyed "<file>:<npz key>" as the snapshot
    names them (Adam's slots by ``slots_whole``), and with ``copy_to`` rank 0
    copies the snapshot's folder there (the folder a run stopped after that
    epoch would have left)."""
    from mamdr_tpu_torch.parallel.mesh import barrier

    save = t.save_resume_state

    def wrapped(epoch, extra_trees=None, optimizers=None):
        save(epoch, extra_trees, optimizers)
        if held:
            return
        if copy_to and t.mesh.rank == 0:
            shutil.copytree(t.resume_dir, copy_to)
        barrier()
        optimizers = optimizers or {}
        held.update(flat_whole("train_state:params//", t.whole(t.state.params)))
        opt = t.state.opt_state
        held["train_state:opt_state//count"] = opt.count.numpy()
        held["train_state:step"] = t.state.step.numpy()
        for k in ("mu", "nu"):
            held[f"train_state:opt_state//{k}"] = slots_whole(t, getattr(opt, k), t.tx)
        for name, tree in (extra_trees or {}).items():
            if name in optimizers:
                held[f"{name}:count"] = tree.count.numpy()
                for k in ("mu", "nu"):
                    held[f"{name}:{k}"] = slots_whole(t, getattr(tree, k), optimizers[name])
            else:
                held.update(flat_whole(f"{name}:", t.whole(tree)))

    t.save_resume_state = wrapped


def spy_starts(trainer):
    """The epochs each ``try_resume`` call of ``trainer`` returned."""
    starts = []
    fn = trainer.try_resume

    def spy(*a, **k):
        r = fn(*a, **k)
        starts.append(-1 if r is None else r[0])
        return r

    trainer.try_resume = spy
    return starts


def case_resume_routes(root, inputs):
    """Each route of ``RESUME_ROUTES`` from the JAX init on (2, 2): 1 epoch
    writing the snapshot (the trees held then kept beside it), then fresh
    trainers resumed to 2 epochs: where they start, np_rng, the early stop,
    the test split and the whole params."""
    from mamdr_tpu_torch.config import ExperimentConfig
    from mamdr_tpu_torch.convert import state_on_mesh
    from mamdr_tpu_torch.data.synthetic import make_synthetic_dataset
    from mamdr_tpu_torch.strategies.base import build_strategy
    from mamdr_tpu_torch.train.trainer import Trainer
    from mamdr_tpu_torch.utils import trees

    mesh = _mesh22()
    whole = trees.unflatten({k[len("init/"):].replace("//", "/"): v
                             for k, v in inputs.items() if k.startswith("init/")})
    for route in RESUME_ROUTES:

        def strategy(epoch, **train):
            t = Trainer(ExperimentConfig.from_dict(resume_config(route, root, "port", epoch,
                                                                 **train)),
                        make_synthetic_dataset(**RESUME_DS), verbose=False, mesh=mesh)
            params, _ = state_on_mesh(whole, mesh, min_rows=16)
            t.state = t.state.replace(params=params, opt_state=t.tx.init(params))
            return t, build_strategy(t)

        held = {}
        tb, sb = strategy(1, resume_every=1)
        assert tb.shard_axes["model"]["embedding"]["user_emb"]
        hold_snapshots(tb, held)
        sb.train()
        tc, sc = strategy(2, resume=True)
        starts = spy_starts(tc)
        sc.train()
        _, _, dloss, dauc = tc.val_and_test("test", params=tc.state.params)
        params = tc.whole(tc.state.params)
        if mesh.rank == 0:
            save(root, f"resume_{route}", starts=np.asarray(starts), dir=tb.resume_dir,
                 np_rng=json.dumps(tc.np_rng.bit_generator.state),
                 stopper=np.asarray([tc.stopper.counter, tc.stopper.best_metric]),
                 test=np.asarray([[dloss[k], dauc[k]] for k in sorted(dloss)]),
                 **flat_whole("p/", params), **held)


def case_tensorboard(root, inputs):
    """``summarize`` of a val, a test and a val evaluation on a (2, 2) mesh
    trainer from the JAX init, TensorBoard with weight and gradient
    histograms on; each rank says whether it opened a writer."""
    mesh = _mesh22()
    t = _mesh_trainer(mesh, root, "tb", inputs, train=TB_TRAIN)
    for mode in TB_MODES:
        t.summarize(mode, dict(TB_LOSS), dict(TB_AUC))
    opened = t.tb._writer is not None
    t.tb.close()
    save(root, f"tb_rank{mesh.rank}", opened=opened,
         logdir=os.path.join(t.checkpoint_dir, "tensorboard"))


EXPERT_CFG = {  # tests/test_expert_parallel.py's recipe
    "model": {"user_dim": 8, "item_dim": 8, "domain_dim": 8, "hidden_dim": [16, 8],
              "tower_hidden_dim": [8], "num_experts": 4, "dropout": 0.0},
    "train": {"epoch": 1, "learning_rate": 0.01, "patience": 1, "metrics_jsonl": False,
              "shard_experts": True, "sharded_lookup_min_rows": 16},
    "dataset": {"name": "synthetic", "batch_size": 64, "seed": 7},
}
EXPERT_DS = dict(n_domain=4, n_uid=64, n_pid=64, n_per_domain=400, seed=7, batch_size=64)


def expert_config(name, root, tag):
    d = json.loads(json.dumps(EXPERT_CFG))
    d["model"]["name"] = name
    d["train"].update(checkpoint_path=os.path.join(root, f"c{tag}"),
                      result_save_path=os.path.join(root, f"r{tag}"))
    return d


def expert_run(t, whole, batch, n_domain=4):
    """Three train steps on ``batch`` from the JAX init ``whole``, then a
    lane step of every domain's first rows and the lane eval of every
    domain: {name: whole arrays}."""
    from mamdr_tpu_torch.convert import state_on_mesh
    from mamdr_tpu_torch.train.steps import make_subset_train_step
    from mamdr_tpu_torch.utils import trace, trees

    if t.mesh is None:
        params = trees.tree_map(lambda x: torch.tensor(np.asarray(x)), whole)
    else:
        params, axes = state_on_mesh(whole, t.mesh, min_rows=16, shard_experts=True)
        assert trees.leaves(axes) == trees.leaves(t.shard_axes)
    t.state = t.state.replace(params=params, opt_state=t.tx.init(params))
    step = t.train_step_fn()
    losses, out = [], {}
    for i in range(3):
        before = trace.counters()
        t.state, loss = step(t.state, batch)
        losses.append(float(loss))
        if i == 0:  # the first step's PLE expert counts (0 for MMoE)
            got = trace.since(before)
            out["counted"] = np.asarray([got.get("ple.expert_rows", 0),
                                         got.get("ple.expert_rows_used", 0)])
        if i == 0 and t.mesh is None:  # the first step's slots, over the whole leaves
            out.update(mu=t.state.opt_state.mu.numpy(), nu=t.state.opt_state.nu.numpy())
    out["losses"] = np.asarray(losses)
    out.update(flat_whole("p/", t.whole(t.state.params)))
    sub_step, to_sub, _ = make_subset_train_step(t.model, t.tx, t.step_cfg, t.frozen_mask(),
                                                 t.state.params)
    lanes = {k: torch.stack([v[d, :64] for d in range(n_domain)])
             for k, v in t.train_block()[0].items()}
    lane_state = t.state.replace(
        params=trees.tree_map(lambda x: x.expand(n_domain, *x.shape).contiguous(),
                              to_sub(t.state.params)),
        opt_state=type(t.state.opt_state)(*(x.expand(n_domain, *x.shape)
                                            for x in t.state.opt_state)),
        seed=torch.arange(n_domain), step=t.state.step.expand(n_domain))
    lane_state, lane_loss = sub_step(lane_state, lanes)
    out["lane_loss"] = lane_loss.numpy()
    out.update(flat_whole("lane/", t.whole(lane_state.params)))
    _, _, dloss, dauc = t.val_and_test("val")
    out["val"] = np.asarray([[dloss[str(d)], dauc[str(d)]] for d in range(n_domain)])
    return out


def _case_experts(name):
    def case(root, inputs):
        from mamdr_tpu_torch.config import ExperimentConfig
        from mamdr_tpu_torch.data.synthetic import make_synthetic_dataset
        from mamdr_tpu_torch.parallel.trainer_sharding import make_sharded_batch
        from mamdr_tpu_torch.train.trainer import Trainer
        from mamdr_tpu_torch.utils import trees

        mesh = _mesh22()
        t = Trainer(ExperimentConfig.from_dict(expert_config(name, root, f"m{name}")),
                    make_synthetic_dataset(**EXPERT_DS), verbose=False, mesh=mesh)
        whole = trees.unflatten({k[len(f"{name}/"):].replace("//", "/"): v
                                 for k, v in inputs.items() if k.startswith(f"{name}/")})
        out = expert_run(t, whole, make_sharded_batch(mesh, 64, 64, 4, 64))
        if mesh.rank == 0:
            save(root, f"experts_{name}", **out)
    return case


CASES = {"lookup": case_lookup, "trainer": case_trainer, "joint_run": case_joint_run,
         "dropout": case_dropout, "sharded_train": case_sharded_train,
         "mamdr_run": case_mamdr_run,
         "experts_mmoe": _case_experts("mmoe"), "experts_ple": _case_experts("ple"),
         "tensorboard": case_tensorboard, "resume_routes": case_resume_routes}
SECONDS = {"resume_routes": 90}  # the cases' own time limits (CASE_SECONDS otherwise)


# ---------------- the pytest side ----------------

def _jax_trainer(tmp_path, tag, mesh, train=None):
    from mamdr_tpu.config import ExperimentConfig as JConfig
    from mamdr_tpu.data.synthetic import make_synthetic_dataset as jax_synthetic
    from mamdr_tpu.train.trainer import Trainer as JTrainer

    cfg = JConfig.from_dict(trainer_config(tag, str(tmp_path), train))
    return JTrainer(cfg, jax_synthetic(**TRAINER_DS), verbose=False, mesh=mesh)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Write the JAX side's inputs, start the four ranks, and hand the tests
    (the JAX mesh, the first JAX trainer, the wait)."""
    import jax
    from mamdr_tpu.ops.embedding_lookup import set_lookup_mesh
    from mamdr_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from mamdr_tpu.parallel.sharded_train import make_sharded_train_step as jax_step
    from mamdr_tpu.train.checkpoints import _flatten as jflatten

    root = tmp_path_factory.mktemp("parallel")
    mesh = jax_make_mesh(jax.devices()[:4], table_parallelism=2)
    try:
        jt = _jax_trainer(root, "jax", mesh)
    finally:
        set_lookup_mesh(None)
    jstep, jstate, jbatch = jax_step(mesh, **TRAIN_STEP)
    st = jax.device_get(jstate.params)
    st = {**st, "dense": {str(i): layer for i, layer in enumerate(st["dense"])}}
    rng = np.random.default_rng(5)
    inputs = {"lookup_table": rng.normal(0, 1, (64, 8)).astype(np.float32),
              "lookup_ct": rng.normal(0, 1, (16, 8)).astype(np.float32)}
    inputs.update({"init/" + k: v for k, v in jflatten(jax.device_get(jt.state.params)).items()})
    inputs.update({"st/" + k: np.asarray(v) for k, v in jflatten(st).items()})
    experts = {}
    from mamdr_tpu.config import ExperimentConfig as JConfig
    from mamdr_tpu.data.synthetic import make_synthetic_dataset as jax_synthetic
    from mamdr_tpu.train.trainer import Trainer as JTrainer

    for name in ("mmoe", "ple"):
        try:
            ej = JTrainer(JConfig.from_dict(expert_config(name, str(root), f"j{name}")),
                          jax_synthetic(**EXPERT_DS), verbose=False,
                          mesh=jax_make_mesh(jax.devices()[:8], table_parallelism=2))
        finally:
            set_lookup_mesh(None)
        inputs.update({f"{name}/{k}": v
                       for k, v in jflatten(jax.device_get(ej.state.params)).items()})
        experts[name] = ej
    np.savez(root / "inputs.npz", **inputs)
    wait = launch(__file__, str(root), 4, list(CASES), SECONDS)
    yield {"mesh": mesh, "jt": jt, "wait": wait, "root": root, "inputs": inputs,
           "jstep": (jstep, jstate, jbatch), "experts": experts}
    set_lookup_mesh(None)


def _load(ranks, name):
    ranks["wait"]()
    with np.load(ranks["root"] / f"{name}.npz") as z:
        return {k: z[k] for k in z.files}


def _leaves_close(got, jax_tree, rtol=2e-5, atol=1e-5, prefix="p/"):
    import jax
    from mamdr_tpu.train.checkpoints import _flatten as jflatten

    want = jflatten(jax.device_get(jax_tree))
    assert sorted(k[len(prefix):] for k in got if k.startswith(prefix)) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[prefix + k], v, rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shape_matches_jax_make_mesh(n):
    import jax
    from mamdr_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from mamdr_tpu_torch.parallel.mesh import mesh_shape

    jm = jax_make_mesh(jax.devices()[:n])
    assert mesh_shape(n) == (jm.shape["data"], jm.shape["table"])
    with pytest.raises(ValueError, match="not divisible"):
        mesh_shape(n, n + 1)


def test_pad_rows_and_process_local_rows():
    from mamdr_tpu.parallel.embedding_shard import pad_rows as jax_pad_rows
    from mamdr_tpu_torch.parallel.data_feed import process_local_rows
    from mamdr_tpu_torch.parallel.embedding_shard import pad_rows

    for n, t in ((64, 2), (50, 4), (1, 4), (100_000, 4), (7, 1)):
        assert pad_rows(n, t) == jax_pad_rows(n, t)
    # the last block takes the remainder, as JAX process_local_rows
    assert [process_local_rows(10, i, 3) for i in range(3)] == [
        slice(0, 3), slice(3, 6), slice(6, 10)]
    assert process_local_rows(8, 1, 2) == slice(4, 8)


@pytest.mark.parametrize("name", ["mlp", "mmoe", "ple", "wdl", "deepfm", "star"])
def test_param_sharding_specs_match_jax_rule(name):
    import jax
    from mamdr_tpu.config import ExperimentConfig as JConfig
    from mamdr_tpu.models.zoo import build_model as jax_build_model
    from mamdr_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from mamdr_tpu.parallel.trainer_sharding import param_sharding_specs as jax_specs
    from mamdr_tpu_torch.config import ExperimentConfig
    from mamdr_tpu_torch.models.zoo import build_model
    from mamdr_tpu_torch.parallel.mesh import Mesh
    from mamdr_tpu_torch.parallel.trainer_sharding import EXPERT, ROW, param_sharding_specs
    from mamdr_tpu_torch.utils import trees

    d = {"model": {"name": name, "user_dim": 8, "item_dim": 8, "domain_dim": 8,
                   "hidden_dim": [16, 8], "dropout": 0.0, "num_experts": 4},
         "train": {}, "dataset": {"name": "synthetic"}}
    params = {"model": build_model(ExperimentConfig.from_dict(d), 64, 64, 4,
                                   generator=torch.Generator().manual_seed(0)).param_tree()}
    jmodel = jax_build_model(JConfig.from_dict(d), 64, 64, 4)
    z = np.zeros(2, np.int32)
    jparams = {"model": jmodel.init({"params": jax.random.PRNGKey(0),
                                     "dropout": jax.random.PRNGKey(0)},
                                    z, z, z, train=False)["params"]}
    jmesh = jax_make_mesh(jax.devices()[:4], table_parallelism=2)
    mesh = Mesh(2, 2, 0, torch.device("cpu"), "gloo", {})
    for experts in (False, True):
        want = dict(zip(trees.param_names(jax.device_get(jparams)), jax.tree_util.tree_leaves(
            jax_specs(jparams, jmesh, shard_experts=experts),
            is_leaf=lambda x: hasattr(x, "spec"))))
        got = dict(trees.leaves_with_names(param_sharding_specs(params, mesh, experts)))
        assert sorted(got) == sorted(want)
        for k, s in want.items():
            spec = tuple(s.spec)
            table_leaf = "user_emb" in k or "item_emb" in k
            expect = (None if not spec else ROW if table_leaf and spec == ("table", None)
                      else EXPERT)
            assert got[k] == expect, (k, spec, got[k])
        assert (EXPERT in got.values()) == (experts and name in ("mmoe", "ple"))


@pytest.mark.parametrize("table_index", [0, 1])
def test_shard_train_state_and_state_on_mesh_cut_the_adam_slots(tmp_path, table_index):
    """A whole state after one step (trainable tables, so their slots are
    not zero) cut to one rank of a (2, 2) mesh: ``shard_train_state`` keeps
    the rank's rows of each sharded table and the same rows of Adam's flat
    slots; ``convert.state_on_mesh`` gives the same from numpy."""
    from mamdr_tpu_torch.config import ExperimentConfig
    from mamdr_tpu_torch.convert import params_to_numpy, state_on_mesh
    from mamdr_tpu_torch.data.synthetic import make_synthetic_dataset
    from mamdr_tpu_torch.parallel.mesh import Mesh
    from mamdr_tpu_torch.parallel.trainer_sharding import shard_train_state, sharded_axes
    from mamdr_tpu_torch.train.trainer import Trainer
    from mamdr_tpu_torch.utils import trees

    t = Trainer(ExperimentConfig.from_dict(trainer_config("cut", str(tmp_path))),
                make_synthetic_dataset(**TRAINER_DS), device="cpu", verbose=False)
    t.state, _ = t.fit_domain(t.state, 0, max_steps=1)
    mesh = Mesh(2, 2, 2 + table_index, torch.device("cpu"), "gloo", {})
    axes = sharded_axes(t.state.params, mesh, 16)
    cut = shard_train_state(t.state, axes, mesh, t.tx)
    rows = slice(32 * table_index, 32 * (table_index + 1))
    mu_whole = dict(zip([n for n, m in trees.leaves_with_names(t.tx.mask) if m],
                        torch.split(t.state.opt_state.mu, [x.numel() for x in
                                                           t.tx._selected(t.state.params)])))
    mu_cut = dict(zip([n for n, m in trees.leaves_with_names(t.tx.mask) if m],
                      torch.split(cut.opt_state.mu, [x.numel() for x in
                                                     t.tx._selected(cut.params)])))
    for name, x in trees.leaves_with_names(t.state.params):
        got = dict(trees.leaves_with_names(cut.params))[name]
        table = name.endswith(("/user_emb", "/item_emb"))
        assert torch.equal(got, x[rows] if table else x), name
        want = mu_whole[name].view(x.shape)
        assert torch.equal(mu_cut[name].view(got.shape), want[rows] if table else want), name
    p, a, opt = state_on_mesh(params_to_numpy(t.state.params), mesh, min_rows=16,
                              opt_state=[x.numpy() for x in t.state.opt_state],
                              trainable_mask=t.tx.mask, device="cpu")
    assert trees.leaves(a) == trees.leaves(axes)
    assert all(torch.equal(u, v) for u, v in zip(trees.leaves(p), trees.leaves(cut.params)))
    assert all(torch.equal(u, v) for u, v in zip(opt, cut.opt_state))


def _jax_side(ranks):
    """The JAX package's side of the snapshot and TensorBoard tests, run
    once, by the first of them, while the ranks work: for each route of
    ``RESUME_ROUTES`` a mesh trainer of 1 epoch with the snapshot on, then a
    fresh one resumed to 2 epochs (its try_resume starts and test results
    kept); and a TensorBoard mesh trainer's ``summarize`` of a val and a
    test evaluation. Every trainer starts from the fixture's init."""
    import jax
    from mamdr_tpu.config import ExperimentConfig as JConfig
    from mamdr_tpu.data.synthetic import make_synthetic_dataset as jax_synthetic
    from mamdr_tpu.ops.embedding_lookup import set_lookup_mesh
    from mamdr_tpu.strategies import build_strategy as jbuild_strategy
    from mamdr_tpu.train.checkpoints import _flatten as jflatten
    from mamdr_tpu.train.trainer import Trainer as JTrainer

    if "jax_side" in ranks:
        return ranks["jax_side"]
    root, mesh = str(ranks["root"]), ranks["mesh"]
    init = {k[len("init/"):]: v for k, v in ranks["inputs"].items() if k.startswith("init/")}

    def trainer(d, ds_kw):
        t = JTrainer(JConfig.from_dict(d), jax_synthetic(**ds_kw), verbose=False, mesh=mesh)
        flat = jflatten(jax.device_get(t.state.params))
        assert sorted(flat) == sorted(init) and all(
            np.array_equal(np.asarray(v), init[k]) for k, v in flat.items())
        return t

    out = {}
    try:
        for route in RESUME_ROUTES:
            first = trainer(resume_config(route, root, "jax", 1, resume_every=1), RESUME_DS)
            jbuild_strategy(first).train()
            jt = trainer(resume_config(route, root, "jax", 2, resume=True), RESUME_DS)
            starts = spy_starts(jt)
            jbuild_strategy(jt).train()
            out[route] = (first, jt, starts, jt.val_and_test("test", params=jt.state.params))
        out["tb"] = trainer(trainer_config("jtb", root, TB_TRAIN), TRAINER_DS)
        for mode in TB_MODES:
            out["tb"].summarize(mode, dict(TB_LOSS), dict(TB_AUC))
    finally:
        set_lookup_mesh(None)
    ranks["jax_side"] = out
    return out


@pytest.mark.parametrize("route", list(RESUME_ROUTES))
def test_resumed_mesh_run_matches_jax_resumed_mesh_run(ranks, route):
    """1 epoch with the snapshot, then fresh trainers resumed to 2, on the
    (2, 2) mesh in both packages from the JAX init: the same start epoch,
    np_rng state and early stop, the test split (loss rtol 1e-4, AUC abs
    1e-5) and every whole parameter within rtol 2e-5 / atol 1e-5. The JAX
    package's resume restarts the domain ``sequence`` from its unshuffled
    order (ROADMAP.md §3), and so does the port's."""
    from test_torch_strategies import results_close

    _, jt, jstarts, jres = _jax_side(ranks)[route]
    got = _load(ranks, f"resume_{route}")
    assert list(got["starts"]) == jstarts == [1]
    assert json.loads(str(got["np_rng"])) == jt.np_rng.bit_generator.state
    assert int(got["stopper"][0]) == jt.stopper.counter
    assert float(got["stopper"][1]) == pytest.approx(jt.stopper.best_metric, abs=1e-5)
    doms = sorted(jres[2])
    results_close((None, None, {k: float(got["test"][i][0]) for i, k in enumerate(doms)},
                   {k: float(got["test"][i][1]) for i, k in enumerate(doms)}), jres)
    _leaves_close(got, jt.state.params)


def test_joint_snapshot_on_mesh_read_by_jax(ranks):
    """The joint route's snapshot written on (2, 2) (its first epoch), read
    by the JAX ``load_pytree`` with the JAX mesh trainer's templates of the
    same config: every key of the JAX state but its PRNG keys (``rng``,
    ``host_rng``: the port keeps its base seed and generators instead), the
    padded shapes, and every value equal to the whole trees the ranks held
    (Adam's slots gathered leaf by leaf); the best params' file likewise."""
    import jax
    from mamdr_tpu.train.checkpoints import _flatten as jflatten
    from mamdr_tpu.train.checkpoints import load_pytree as jax_load_pytree

    jt = _jax_side(ranks)["joint_fused"][0]
    got = _load(ranks, "resume_joint_fused")
    snap = str(got["dir"])
    template = {"params": jt.state.params, "opt_state": jt.state.opt_state,
                "batch_stats": jt.state.batch_stats, "step": jt.state.step}
    with np.load(os.path.join(snap, "train_state.npz")) as z:
        keys = set(z.files)
    port_only = {"seed", "generator//seed_gen", "generator//gen"}
    assert port_only <= keys and keys - port_only == set(jflatten(jax.device_get(template)))
    for name, tmpl in (("train_state", template), ("best_params", jt.state.params)):
        loaded = jflatten(jax_load_pytree(os.path.join(snap, f"{name}.npz"), tmpl))
        held = {k[len(name) + 1:] for k in got if k.startswith(name + ":")}
        assert held == set(loaded), name
        for k, v in loaded.items():
            assert np.array_equal(np.asarray(v), got[f"{name}:{k}"]), (name, k)
    with open(os.path.join(snap, "resume_meta.json")) as f:
        meta = json.load(f)
    assert sorted(meta) == ["epoch", "extra_trees", "np_rng_state", "stopper"]
    assert meta["epoch"] == 0 and meta["extra_trees"] == ["best_params"]
    assert sorted(os.listdir(snap)) == ["best_params.npz", "resume_meta.json",
                                        "train_state.npz"]


def test_tensorboard_on_mesh_writes_what_the_jax_mesh_trainer_writes(ranks):
    """``summarize`` on (2, 2) against the JAX mesh trainer's, from the same
    init: tags, steps and scalars equal, the weight histograms of the whole
    padded tree (each shard counted on its rank) and the ``grad/``
    histograms as ``test_torch_tensorboard`` holds them on one device; only
    rank 0 opens a writer, and the folder holds its one event file."""
    from mamdr_tpu_torch.utils import trees
    from test_torch_tensorboard import _accumulator, _histograms_equal

    jt = _jax_side(ranks)["tb"]
    init = {k[len("init/"):]: v for k, v in ranks["inputs"].items() if k.startswith("init/")}
    got = [_load(ranks, f"tb_rank{r}") for r in range(4)]
    assert [bool(g["opened"]) for g in got] == [True, False, False, False]
    logdir = str(got[0]["logdir"])
    assert all(str(g["logdir"]) == logdir for g in got)
    assert len(os.listdir(logdir)) == 1
    ja = _accumulator(os.path.join(jt.checkpoint_dir, "tensorboard"))
    ta = _accumulator(logdir)
    assert sorted(ta.Tags()["scalars"]) == sorted(ja.Tags()["scalars"])
    for tag in ja.Tags()["scalars"]:
        assert ([(e.step, e.value) for e in ta.Scalars(tag)]
                == [(e.step, e.value) for e in ja.Scalars(tag)]), tag
    names = trees.param_names(trees.unflatten({k.replace("//", "/"): 0 for k in init}))
    assert sorted(ta.Tags()["histograms"]) == sorted(ja.Tags()["histograms"]) == sorted(
        names + [f"grad/{n}" for n in names])
    for tag in ja.Tags()["histograms"]:
        jh, th = ja.Histograms(tag), ta.Histograms(tag)
        assert [h.step for h in th] == [0], tag
        for a, b in zip(th, jh):
            _histograms_equal(a, b, tag, 2e-5 if tag.startswith("grad/") else 0.0)


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_sharded_lookup_matches_jax(ranks, shape):
    import jax
    import jax.numpy as jnp
    from mamdr_tpu.parallel.embedding_shard import sharded_lookup as jax_lookup
    from mamdr_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from mamdr_tpu_torch.ops.embedding_lookup import embedding_lookup_reference

    table, ct = ranks["inputs"]["lookup_table"], ranks["inputs"]["lookup_ct"]
    jmesh = jax_make_mesh(jax.devices()[:4], table_parallelism=shape[1])
    jout, vjp = jax.vjp(lambda t: jax_lookup(jmesh, t, jnp.asarray(LOOKUP_IDS)),
                        jnp.asarray(table))
    (jgrad,) = vjp(jnp.asarray(ct))
    got = _load(ranks, f"lookup_{shape[0]}x{shape[1]}")
    inside = (LOOKUP_IDS >= 0) & (LOOKUP_IDS < table.shape[0])
    plain = embedding_lookup_reference(torch.from_numpy(table), torch.from_numpy(LOOKUP_IDS))
    assert np.array_equal(got["out"][inside], plain.numpy()[inside])  # bit-equal
    assert not got["out"][~inside].any() and not np.asarray(jout)[~inside].any()  # zeros
    assert np.array_equal(got["out"], np.asarray(jout))
    np.testing.assert_allclose(got["grad"], np.asarray(jgrad), rtol=1e-6, atol=1e-6)


def test_trainer_fit_and_evaluate_domain_match_jax_mesh(ranks):
    from mamdr_tpu.ops.embedding_lookup import set_lookup_mesh

    jt = ranks["jt"]
    # the JAX trainer's lookups take the row-sharded path while it traces
    # (the process-wide mesh its construction set, reset by the fixture)
    set_lookup_mesh(ranks["mesh"], TRAINER_CFG["train"]["sharded_lookup_min_rows"])
    try:
        jt.state, jloss = jt.fit_domain(jt.state, 0)
        jl, ja = jt.evaluate_domain("val", 0, jt.state.params, jt.state.batch_stats)
    finally:
        set_lookup_mesh(None)
    got = _load(ranks, "trainer")
    np.testing.assert_allclose(float(got["loss"]), float(jloss), rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(got["val"], [jl, ja], rtol=2e-5, atol=1e-5)
    _leaves_close(got, jt.state.params)


def test_joint_run_on_mesh_files_read_by_jax(ranks):
    from mamdr_tpu.train.checkpoints import load_pytree as jax_load_pytree
    from mamdr_tpu.train.checkpoints import _flatten as jflatten

    got = _load(ranks, "joint_run")
    assert int(got["n_domain"]) == 2 and np.all(np.isfinite(got["avg"]))
    path = str(got["path"])
    template = ranks["jt"].state.params  # the JAX mesh trainer's padded shapes
    loaded = jflatten(jax_load_pytree(path, template))
    for k, v in loaded.items():
        assert np.array_equal(np.asarray(v), got["p/" + k]), k
    result_dirs = [os.path.join(dp, f) for dp, _, fs in os.walk(ranks["root"] / "rrun")
                   for f in fs if f == "model_parameters.npz"]
    assert len(result_dirs) == 1  # written once, by rank 0
    jflat = jflatten(jax_load_pytree(result_dirs[0], template))
    assert all(np.array_equal(np.asarray(v), got["p/" + k]) for k, v in jflat.items())


def test_mamdr_run_on_mesh_decomposition_read_by_jax(ranks):
    import jax
    from mamdr_tpu.train.checkpoints import _flatten as jflatten
    from mamdr_tpu.train.checkpoints import load_decomposition as jax_load_decomposition

    got = _load(ranks, "mamdr_run")
    assert got["dauc"].shape == (2,) and np.all(np.isfinite(got["dauc"]))
    template = ranks["jt"].state.params  # the padded shapes (64 rows: no padding)
    shared, specific, meta = jax_load_decomposition(str(got["dir"]), template)
    assert meta["n_domain"] == 2 and meta["masked_only"]
    for prefix, tree in (("shared/", shared), ("spec0/", specific[0])):
        for k, v in jflatten(jax.device_get(tree)).items():
            assert np.array_equal(np.asarray(v), got[prefix + k]), prefix + k


def test_dropout_masks_on_mesh_equal_one_device(ranks):
    from mamdr_tpu_torch.config import ExperimentConfig
    from mamdr_tpu_torch.convert import params_from_jax
    from mamdr_tpu_torch.data.synthetic import make_synthetic_dataset
    from mamdr_tpu_torch.train.trainer import Trainer
    from mamdr_tpu_torch.utils import trees

    root = str(ranks["root"])
    t = Trainer(ExperimentConfig.from_dict(trainer_config("one", root, dropout=0.5)),
                make_synthetic_dataset(**TRAINER_DS), device="cpu", verbose=False)
    init = {k[len("init/"):].replace("//", "/"): v
            for k, v in ranks["inputs"].items() if k.startswith("init/")}
    params = params_from_jax(trees.unflatten(init))
    t.state = t.state.replace(params=params, opt_state=t.tx.init(params))
    before = trees.tree_map(torch.clone, t.state.params)
    t.state, loss = t.fit_domain(t.state, 0)
    got = _load(ranks, "dropout")
    np.testing.assert_allclose(float(got["loss"]), float(loss), rtol=1e-5)
    for (name, x), x0 in zip(trees.leaves_with_names(t.state.params), trees.leaves(before)):
        x, moved = x.numpy(), (x - x0).abs().max().item()
        scale = np.abs(x).max()
        assert np.abs(got["p/" + name.replace("/", "//")] - x).max() <= 1e-4 * scale, name
        assert moved > 1e-4 * scale or "user_emb" in name or "item_emb" in name, name


def test_sharded_train_step_matches_jax(ranks):
    import jax
    from mamdr_tpu.train.checkpoints import _flatten as jflatten

    jstep, jstate, jbatch = ranks["jstep"]
    jlosses = []
    for _ in range(3):
        jstate, loss = jstep(jstate, jbatch)
        jlosses.append(float(loss))
    got = _load(ranks, "sharded_train")
    np.testing.assert_allclose(got["losses"], jlosses, rtol=2e-5, atol=1e-6)
    want = jax.device_get(jstate.params)
    want = {**want, "dense": {str(i): layer for i, layer in enumerate(want["dense"])}}
    for k, v in jflatten(want).items():
        np.testing.assert_allclose(got["p/" + k], v, rtol=2e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", ["mmoe", "ple"])
def test_shard_experts_match_jax_and_one_process(ranks, name):
    import jax
    from mamdr_tpu.parallel.trainer_sharding import make_sharded_batch as jax_batch
    from mamdr_tpu.train.steps import make_train_step as jax_make_train_step
    from mamdr_tpu_torch.config import ExperimentConfig
    from mamdr_tpu_torch.data.synthetic import make_synthetic_dataset
    from mamdr_tpu_torch.train.trainer import Trainer
    from mamdr_tpu_torch.utils import trees

    ej = ranks["experts"][name]
    jbatch = {k: np.asarray(v) for k, v in jax_batch(
        ej.mesh, 64, 64, 4, 64).items()}
    jstep = jax.jit(jax_make_train_step(ej.model, ej.tx, ej.step_cfg)[0])
    js, jlosses = ej.state, []
    for i in range(3):
        js, loss = jstep(js, jbatch)
        jlosses.append(float(loss))
        if i == 0:
            jslots = {k: np.asarray(getattr(js.opt_state, k)) for k in ("mu", "nu")}
    whole = trees.unflatten({k[len(f"{name}/"):].replace("//", "/"): v
                             for k, v in ranks["inputs"].items() if k.startswith(f"{name}/")})
    t = Trainer(ExperimentConfig.from_dict(expert_config(name, str(ranks["root"]), f"o{name}")),
                make_synthetic_dataset(**EXPERT_DS), device="cpu", verbose=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = expert_run(t, whole, {k: torch.tensor(v) for k, v in jbatch.items()})
    finally:
        torch.set_num_threads(threads)
    got = _load(ranks, f"experts_{name}")
    assert sorted(got) == sorted(k for k in one if k not in ("mu", "nu"))
    # PLE's counters over the first step (T=4, t=s=1, two levels): the one
    # process's whole task leaves compute every task's first level and the
    # batch's task's last, 7 experts a row, what the head reads; rank 0
    # holds 2 of the 4 tasks' experts, so it computes 2*1 + 1 a level over
    # its data half of the rows, and reads 7 a row
    counted, one_counted = got.pop("counted").tolist(), one.pop("counted").tolist()
    if name == "ple":
        assert one_counted == [64 * 7, 64 * 7]
        assert counted == [32 * 2 * (2 + 1), 32 * 7]
    else:
        assert counted == one_counted == [0, 0]
    # the mesh against one process: losses and evaluations at rtol 2e-5 /
    # atol 2e-5; params with an absolute floor of lr/100: a PLE tower bias
    # whose gradient is rounding noise takes Adam steps of order lr steered
    # by its last bits (measured 2.9e-5 between mesh and one process, 5.8e-5
    # between one process and JAX without any mesh)
    for k in got:
        floor = 1e-4 if k.startswith(("p/", "lane/")) else 2e-5
        np.testing.assert_allclose(got[k], one[k], rtol=2e-5, atol=floor, err_msg=k)
    # against the JAX expert-sharded run: the three losses, and Adam's slots
    # after the first step (linear and quadratic in its gradient) of the one
    # process; later slots follow the params' rounding-noise steps
    np.testing.assert_allclose(got["losses"], jlosses, rtol=2e-5, atol=2e-6)
    for slot, want in jslots.items():
        np.testing.assert_allclose(one[slot], want, rtol=2e-5,
                                   atol=2e-5 * float(np.abs(want).max()), err_msg=slot)


if __name__ == "__main__":
    rank_main(CASES, SECONDS)
