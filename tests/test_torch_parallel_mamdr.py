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

from test_torch_parallel import launch, rank_main, save

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


def _trainer(root, kind, mesh=None, tag=None):
    from mamdr_tpu_torch.config import ExperimentConfig
    from mamdr_tpu_torch.data.synthetic import make_synthetic_dataset
    from mamdr_tpu_torch.strategies.mamdr import MAMDRStrategy
    from mamdr_tpu_torch.train.trainer import Trainer

    t = Trainer(ExperimentConfig.from_dict(config_dict(root, kind, tag)),
                dataset(make_synthetic_dataset), device="cpu", verbose=False, mesh=mesh)
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


CASES = {"frozen": _case("frozen"), "trainable": _case("trainable"), "gates": case_gates}


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
