"""MAMDR's fused epoch on the port's (2, 2) mesh of gloo ranks, against the
port's one process and the JAX package's mesh.

Four CPU ranks (``test_torch_parallel.launch``) run the recipe of
``tests/test_torch_dr_phase.py`` at four domains — ``shuffle=False``,
dropout off, the same fixed domain order and support draws, the JAX init
and specific stack carried across (``convert.state_on_mesh``) — with
frozen tables and with trainable ones (the trainable run's DR lanes in
groups of 2, each group split over the data ranks):

- the DR lanes from the entry state, on the mesh against one process: bit
  for bit (each lane runs whole on one data rank, and a row-sharded lookup
  adds exact zeros), the specific stack and the returned last-lane state;
- the merged validation of the entry weights, each domain on one data
  rank: AUC bit for bit, the loss within 1e-6 (its l2 term sums the table
  shards in another order);
- a whole epoch, DN then DR, and its merged validation: against one process
  and against the JAX ``make_fused_mamdr`` / ``make_fused_dr_parallel`` on
  ``make_mesh(jax.devices()[:4], table_parallelism=2)``, rtol 2e-5 and atol
  1e-5 on parameters (the DN steps are data-parallel, so the gradients are
  summed in another order), AUC within 1e-4;
- MAMDR's ``run()`` resumed on the mesh from the snapshot after its first
  epoch, bit-equal to the unbroken run on the mesh, every rank's random
  streams alike; the snapshot read by the JAX ``load_pytree`` with the JAX
  mesh trainer's templates (every key, shape and value);
- the mesh gates of ``MAMDRStrategy``: lanes refused when the domains or
  ``dr_lane_chunk`` do not divide the data axis, the automatic group of a
  trainable-table run a multiple of it; and ``Trainer(mesh=)``'s refusal of
  a domain 0 with fewer train rows than data ranks.
"""

import json
import os

import numpy as np
import pytest
import torch

from test_torch_parallel import hold_snapshots, launch, rank_main, save, spy_starts

N_DOMAIN, BATCH = 4, 32
ORDER = np.asarray([2, 0, 3, 1], np.int32)
AUX = np.asarray([[0, 1, 2], [3, 2, 0], [1, 0, 3], [2, 3, 1]], np.int32)
CONFIGS = {"frozen": {"emb_trainable": False},
           "trainable": {"emb_trainable": True, "dr_lane_chunk": 2}}


def config_dict(root, kind, tag=None):
    tag = tag or kind
    return {
        "model": {"name": "mlp_meta_mamdr_finetune", "user_dim": 8, "item_dim": 8,
                  "domain_dim": 8, "hidden_dim": [32, 16], "dropout": 0.0},
        "train": {"load_pretrain_emb": True, "learning_rate": 1e-2,
                  "meta_learning_rate": 0.1, "sample_num": 2, "add_query_domain": True,
                  "shuffle_sequence": True, "metrics_jsonl": False,
                  "sharded_lookup_min_rows": 16,
                  "checkpoint_path": os.path.join(root, f"ckpt_{tag}"),
                  "result_save_path": os.path.join(root, f"result_{tag}"),
                  **CONFIGS[kind]},
        "dataset": {"name": "synthetic", "batch_size": BATCH, "seed": 21},
    }


def dataset(make):
    ds = make(n_domain=N_DOMAIN, n_uid=50, n_pid=60, n_per_domain=300, seed=21,
              long_tail=True, batch_size=BATCH)
    rng = np.random.default_rng(0)
    ds.user_emb = rng.normal(0, 0.1, (50, 8)).astype(np.float32)
    ds.item_emb = rng.normal(0, 0.1, (60, 8)).astype(np.float32)
    return ds


def port_phases(t, s):
    """(block, dn, dr lanes, merged eval) of the port, shuffles off."""
    from mamdr_tpu_torch.train import fused
    from mamdr_tpu_torch.train.steps import make_subset_train_step

    block, n_steps = t.train_block()
    steps = t.steps_per_domain()
    dn, _ = fused.make_fused_mamdr(t.train_step_fn(), s.mask, "plus", n_steps, BATCH, 0,
                                   shuffle=False, steps_list=steps)
    sub_step, to_sub, combine = make_subset_train_step(
        t.model, t.tx, t.step_cfg, t.frozen_mask(), t.state.params)
    dr = fused.make_fused_dr_parallel(
        sub_step, to_sub, combine, s.mask, "plus", n_steps, BATCH, 0, shuffle=False,
        steps_list=steps, lane_chunk=t.config.train.dr_lane_chunk, mesh=t.mesh)
    ev = fused.make_fused_eval_merged(t.model, t.step_cfg, s.mask, "plus")
    return block, dn, dr, ev


def port_run(t, s, inputs, kind):
    """Load the JAX init and specific stack, then: the DR lanes from the
    entry state, the merged validation of the entry weights, and a whole
    epoch (DN, DR) with its merged validation. Returns {name: whole arrays}."""
    from mamdr_tpu_torch.convert import state_on_mesh
    from mamdr_tpu_torch.train.checkpoints import _flatten
    from mamdr_tpu_torch.utils import trees

    def tree(prefix):
        return trees.unflatten({k[len(prefix):].replace("//", "/"): v
                                for k, v in inputs.items() if k.startswith(prefix)})

    from mamdr_tpu_torch.convert import params_from_jax

    if t.mesh is None:
        params = params_from_jax(tree(f"{kind}/init/"))
    else:
        params, axes = state_on_mesh(tree(f"{kind}/init/"), t.mesh, min_rows=16)
        assert trees.leaves(axes) == trees.leaves(t.shard_axes)
    # the stack's table leaves [D, rows, 8] keep this rank's rows
    stack = t._shard(params_from_jax(tree(f"{kind}/stack/")), t.shard_axes)
    shared = params
    t.state = t.state.replace(params=params, opt_state=t.tx.init(params))
    stack = trees.tree_map(lambda m, x, p: x if m else p, s.mask, stack, params)
    block, dn, dr, ev = port_phases(t, s)
    out = {}

    def keep(prefix, x):
        out.update({prefix + k: v for k, v in _flatten(t.whole(x)).items() if v.ndim})

    st, stk = dr(t.state, shared, stack, block, ORDER, AUX, t.gen, 0.1)
    keep("dr_stack/", stk)
    keep("dr_state/", st.params)
    out["dr_step"] = np.asarray(int(st.step))
    losses, aucs = ev(t.state.params, shared, stack, t.eval_block("val"))
    out["eval0"] = torch.stack([losses, aucs]).numpy()
    st, shared, dn_losses = dn(t.state, shared, block, ORDER, t.gen, 0.1)
    st, stk = dr(st, shared, stack, block, ORDER, AUX, t.gen, 0.1)
    keep("epoch_shared/", shared)
    keep("epoch_stack/", stk)
    keep("epoch_state/", st.params)
    losses, aucs = ev(st.params, shared, stk, t.eval_block("val"))
    out["eval1"] = torch.stack([losses, aucs]).numpy()
    out["dn_losses"] = dn_losses.numpy()
    return out


def _trainer(root, kind, mesh=None, tag=None, **train):
    from mamdr_tpu_torch.config import ExperimentConfig
    from mamdr_tpu_torch.data.synthetic import make_synthetic_dataset
    from mamdr_tpu_torch.strategies.mamdr import MAMDRStrategy
    from mamdr_tpu_torch.train.trainer import Trainer

    d = config_dict(root, kind, tag)
    d["train"].update(train)
    t = Trainer(ExperimentConfig.from_dict(d), dataset(make_synthetic_dataset), device="cpu",
                verbose=False, mesh=mesh)
    return t, MAMDRStrategy(t)


# ---------------- the ranks' cases (no JAX) ----------------

def _case(kind):
    def case(root, inputs):
        from mamdr_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(table_parallelism=2, device="cpu")
        t, s = _trainer(root, kind, mesh)
        emb = t.shard_axes["model"]["embedding"]
        assert emb["user_emb"] and emb["item_emb"] and not emb["domain_emb"]
        out = port_run(t, s, inputs, kind)
        if mesh.rank == 0:
            save(root, f"mamdr_{kind}", **out)
    return case


def case_gates(root, inputs):
    from mamdr_tpu_torch.config import ExperimentConfig
    from mamdr_tpu_torch.data.synthetic import make_synthetic_dataset
    from mamdr_tpu_torch.parallel.mesh import make_mesh
    from mamdr_tpu_torch.strategies.mamdr import MAMDRStrategy
    from mamdr_tpu_torch.train.trainer import Trainer

    mesh = make_mesh(table_parallelism=2, device="cpu")
    res = {}
    for tag, n_domain, train in (("odd", 3, {}), ("chunk3", 4, {"dr_lane_chunk": 3}),
                                 ("auto8", 8, {"emb_trainable": True})):
        d = config_dict(root, "frozen")
        d["train"].update(train)
        ds = make_synthetic_dataset(n_domain=n_domain, n_uid=50, n_pid=60, n_per_domain=100,
                                    seed=21, batch_size=BATCH)
        s = MAMDRStrategy(Trainer(ExperimentConfig.from_dict(d), ds, device="cpu",
                                  verbose=False, mesh=mesh))
        res[tag] = [s._dr_parallel_eligible(), s._lane_chunk()]
        rows = s._row_sharded_table_mask()["model"]["embedding"]
        assert rows["user_emb"] and rows["item_emb"] and not rows["domain_emb"]
        d["train"]["dr_parallel"] = "on"
        try:
            MAMDRStrategy(Trainer(ExperimentConfig.from_dict(d), ds, device="cpu",
                                  verbose=False, mesh=mesh))._dr_parallel_eligible()
            res[tag].append("")
        except ValueError as e:
            res[tag].append(str(e))
    small = make_synthetic_dataset(n_domain=4, n_uid=50, n_pid=60, n_per_domain=100,
                                   seed=21, batch_size=BATCH)
    small.train[0] = small.train[0].take(np.arange(1))  # one row, two data ranks
    try:
        Trainer(ExperimentConfig.from_dict(config_dict(root, "frozen")), small, device="cpu",
                verbose=False, mesh=mesh)
        res["small"] = ""
    except ValueError as e:
        res["small"] = str(e)
    if mesh.rank == 0:
        save(root, "gates", res=json.dumps(res))


def case_resume(root, inputs):
    """MAMDR's ``run()`` of 2 epochs on (2, 2), trainable tables, the
    snapshot written every epoch (a); the snapshot after its first epoch
    copied aside with the whole trees held then (``hold_snapshots``), and
    fresh trainers resumed from the copy to 2 epochs (c). Each rank holds
    (c) to (a) leaf by leaf — its state, Adam's slots, shared, every
    specific, the best snapshot — and (c)'s results to (a)'s, and writes the
    names that differ and its random streams' states."""
    from mamdr_tpu_torch.parallel.mesh import make_mesh
    from mamdr_tpu_torch.utils import trees

    mesh = make_mesh(table_parallelism=2, device="cpu")
    train = {"epoch": 2, "patience": 5}
    ta, sa = _trainer(root, "trainable", mesh, "resume_a", resume_every=1, **train)
    copy = ta.resume_dir.replace("ckpt_resume_a", "ckpt_resume_c")
    held = {}
    hold_snapshots(ta, held, copy_to=copy)
    res_a = sa.run()
    tc, sc = _trainer(root, "trainable", mesh, "resume_c", resume=True, **train)
    assert tc.resume_dir == copy
    starts = spy_starts(tc)
    res_c = sc.run()
    pairs = [("state", tc.state.params, ta.state.params), ("shared", sc.shared, sa.shared),
             ("best_shared", sc.best_shared, sa.best_shared)]
    pairs += [(f"specific{d}", c, a) for d, (c, a) in enumerate(zip(sc.specific, sa.specific))]
    pairs += [(f"best_specific{d}", c, a)
              for d, (c, a) in enumerate(zip(sc.best_specific, sa.best_specific))]
    differ = [f"{what}/{n}" for what, c, a in pairs
              for (n, x), y in zip(trees.leaves_with_names(c), trees.leaves(a))
              if not torch.equal(x, y)]
    differ += [f"opt/{k}" for k in ("count", "mu", "nu")
               if not torch.equal(getattr(tc.state.opt_state, k), getattr(ta.state.opt_state, k))]
    differ += ["results"] * (res_c != res_a) + ["step"] * (int(tc.state.step) != int(ta.state.step))
    assert len(trees.leaves(sa.specific[0])) > 0 and len(pairs) == 3 + 2 * N_DOMAIN
    save(root, f"resume_rank{mesh.rank}", differ=json.dumps(differ), starts=np.asarray(starts),
         np_rng=json.dumps(ta.np_rng.bit_generator.state),
         seed_gen=ta._seed_gen.get_state().numpy(), gen=ta.gen.get_state().numpy())
    if mesh.rank == 0:
        save(root, "resume_snapshot", dir=copy, **held)


CASES = {"frozen": _case("frozen"), "trainable": _case("trainable"), "gates": case_gates,
         "resume": case_resume}


# ---------------- the pytest side ----------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The JAX mesh trainers' init and specific stacks as inputs, then the
    four ranks; yields the JAX pieces and the wait."""
    import jax
    from mamdr_tpu.config import ExperimentConfig as JConfig
    from mamdr_tpu.data.synthetic import make_synthetic_dataset as jax_synthetic
    from mamdr_tpu.ops.embedding_lookup import set_lookup_mesh
    from mamdr_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from mamdr_tpu.strategies.mamdr import MAMDRStrategy as JMAMDR
    from mamdr_tpu.train import fused as jfused
    from mamdr_tpu.train.checkpoints import _flatten as jflatten
    from mamdr_tpu.train.trainer import Trainer as JTrainer

    root = tmp_path_factory.mktemp("parallel_mamdr")
    mesh = jax_make_mesh(jax.devices()[:4], table_parallelism=2)
    jax_side, inputs = {}, {}
    try:  # the JAX trainers set the process-wide lookup mesh; the tests trace under it
        for kind in CONFIGS:
            jt = JTrainer(JConfig.from_dict(config_dict(str(root), kind, f"jax_{kind}")),
                          dataset(jax_synthetic), verbose=False, mesh=mesh)
            js = JMAMDR(jt)
            stack = jfused.stack_specific(js.specific, js.mask)
            inputs.update({f"{kind}/init/{k}": v
                           for k, v in jflatten(jax.device_get(jt.state.params)).items()})
            inputs.update({f"{kind}/stack/{k}": v
                           for k, v in jflatten(jax.device_get(stack)).items()})
            jax_side[kind] = (jt, js, stack)
    except BaseException:
        set_lookup_mesh(None)
        raise
    np.savez(root / "inputs.npz", **inputs)
    wait = launch(os.path.join(os.path.dirname(__file__), "test_torch_parallel_mamdr.py"),
                  str(root), 4, list(CASES))
    yield {"root": root, "inputs": inputs, "jax": jax_side, "wait": wait}
    set_lookup_mesh(None)


def _load(ranks, name):
    ranks["wait"]()
    with np.load(ranks["root"] / f"{name}.npz") as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def one_process(ranks):
    """The port's single-process runs of both configs (no mesh), on one
    thread as the ranks run: the CPU's plain matrix products may round by
    another blocking on more threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {kind: port_run(*_trainer(str(ranks["root"]), kind, tag=f"one_{kind}"),
                               ranks["inputs"], kind) for kind in CONFIGS}
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_dr_lanes_on_mesh_equal_one_process(ranks, one_process, kind):
    got, want = _load(ranks, f"mamdr_{kind}"), one_process[kind]
    keys = [k for k in want if k.startswith(("dr_stack/", "dr_state/"))]
    assert keys and sorted(keys) == sorted(k for k in got if k.startswith(("dr_", )) and "/" in k)
    for k in keys:
        assert np.array_equal(got[k], want[k]), k
    assert int(got["dr_step"]) == int(want["dr_step"])


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_merged_eval_on_mesh_equals_one_process(ranks, one_process, kind):
    got, want = _load(ranks, f"mamdr_{kind}"), one_process[kind]
    assert np.array_equal(got["eval0"][1], want["eval0"][1])  # AUC: the counts are exact
    np.testing.assert_allclose(got["eval0"][0], want["eval0"][0], rtol=1e-6)


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_mamdr_epoch_on_mesh_matches_one_process_and_jax_mesh(ranks, one_process, kind):
    import jax
    from mamdr_tpu.train import fused as jfused
    from mamdr_tpu.train.checkpoints import _flatten as jflatten
    from mamdr_tpu.train.steps import make_subset_train_step as jax_subset
    from mamdr_tpu.utils import trees as jtrees

    got, want = _load(ranks, f"mamdr_{kind}"), one_process[kind]
    for k in want:
        if k.startswith("epoch_"):
            np.testing.assert_allclose(got[k], want[k], rtol=2e-5, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["eval1"][1], want["eval1"][1], atol=1e-4)
    np.testing.assert_allclose(got["dn_losses"], want["dn_losses"], rtol=1e-5)

    jt, js, stack = ranks["jax"][kind]
    block, n_steps = jt.train_block()
    steps = jt.steps_per_domain()
    dn, _ = jfused.make_fused_mamdr(jt.train_step_fn(), js.mask, "plus", n_steps, BATCH, 0,
                                    shuffle=False, steps_list=steps)
    frozen = jtrees.named_tree_map(
        lambda n, x: (not js.tc.emb_trainable) and ("user_emb" in n or "item_emb" in n),
        jt.state.params)
    sub_step, to_sub, combine = jax_subset(jt.model, jt.tx, jt.step_cfg, frozen,
                                           jt.state.params)
    dr = jfused.make_fused_dr_parallel(sub_step, to_sub, combine, js.mask, "plus", n_steps,
                                       BATCH, 0, shuffle=False, steps_list=steps)
    st, shared, _ = dn(jt.state, js.shared, block, ORDER, jax.random.PRNGKey(0), 0.1)
    st, stk = dr(st, shared, stack, block, ORDER, AUX, jax.random.PRNGKey(1), 0.1)
    for prefix, tree in (("epoch_shared/", shared), ("epoch_stack/", stk),
                         ("epoch_state/", st.params)):
        for k, v in jflatten(jax.device_get(tree)).items():
            if prefix + k in got:
                np.testing.assert_allclose(got[prefix + k], v, rtol=2e-5, atol=1e-5,
                                           err_msg=prefix + k)
    jev = jfused.make_fused_eval_merged(jt.loss_fn, js.mask, "plus",
                                        steps_list=jt.eval_steps_per_domain("val"))
    jl, ja = jev(st.params, st.batch_stats, shared, stk, jt.eval_block("val"))
    np.testing.assert_allclose(got["eval1"][1], np.asarray(ja), atol=1e-4)
    np.testing.assert_allclose(got["eval1"][0], np.asarray(jl), rtol=1e-4)


def test_mamdr_resumed_on_mesh_equals_unbroken(ranks):
    """(c), resumed on fresh trainers from the snapshot after (a)'s first
    epoch, ends where the unbroken (a) ends, bit for bit, on every rank; and
    every rank's random streams (numpy, the CPU and the device generator)
    are in the same state, as the snapshot's single copy of them assumes."""
    got = [_load(ranks, f"resume_rank{r}") for r in range(4)]
    for r, g in enumerate(got):
        assert json.loads(str(g["differ"])) == [], r
        assert list(g["starts"]) == [1], r
    for k in ("np_rng", "seed_gen", "gen"):
        assert all(np.array_equal(g[k], got[0][k]) for g in got), k


def test_mamdr_snapshot_on_mesh_read_by_jax(ranks):
    """The snapshot the (2, 2) MAMDR run wrote after its first epoch, read by
    the JAX ``load_pytree`` with the JAX mesh trainer's templates of the
    same config (its state; shared and its stacked specific weights for the
    extra trees): every key of the JAX state but its PRNG keys, the padded
    shapes, and every value equal to the whole trees the ranks held then
    (Adam's slots over the trainable tables' shards gathered leaf by leaf)."""
    import jax
    from mamdr_tpu.train.checkpoints import _flatten as jflatten
    from mamdr_tpu.train.checkpoints import load_pytree as jax_load_pytree

    jt, js, stack = ranks["jax"]["trainable"]
    got = _load(ranks, "resume_snapshot")
    snap = str(got["dir"])
    state = {"params": jt.state.params, "opt_state": jt.state.opt_state,
             "batch_stats": jt.state.batch_stats, "step": jt.state.step}
    with np.load(os.path.join(snap, "train_state.npz")) as z:
        keys = set(z.files)
    port_only = {"seed", "generator//seed_gen", "generator//gen"}
    assert port_only <= keys and keys - port_only == set(jflatten(jax.device_get(state)))
    files = {"train_state": state, "shared": js.shared, "spec_stack": stack,
             "best_shared": js.shared, "best_spec_stack": stack}
    assert sorted(os.listdir(snap)) == sorted([f"{f}.npz" for f in files] + ["resume_meta.json"])
    for name, template in files.items():
        loaded = jflatten(jax_load_pytree(os.path.join(snap, f"{name}.npz"), template))
        assert {k[len(name) + 1:] for k in got if k.startswith(name + ":")} == set(loaded)
        for k, v in loaded.items():
            assert np.array_equal(np.asarray(v), got[f"{name}:{k}"]), (name, k)
    with open(os.path.join(snap, "resume_meta.json")) as f:
        meta = json.load(f)
    assert meta["epoch"] == 0
    assert meta["extra_trees"] == sorted(k for k in files if k != "train_state")


def test_mamdr_mesh_gates(ranks):
    res = json.loads(str(_load(ranks, "gates")["res"]))
    assert res["odd"][0] is False and "n_domain 3 does not divide" in res["odd"][2]
    assert res["chunk3"][0] is False and "dr_lane_chunk 3" in res["chunk3"][2]
    # trainable tables, 8 domains, data axis 2: groups of max((7 // 2) * 2, 2) = 6
    assert res["auto8"][1] == 6 and res["auto8"][2] == ""
    # the JAX package's refusal of a domain 0 smaller than the data axis
    assert "domain 0 has 1 train rows but the mesh data axis has 2" in res["small"]


if __name__ == "__main__":
    rank_main(CASES)
