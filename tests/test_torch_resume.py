"""The port's resume snapshot, held to the JAX package's, on the CPU.

- A round trip of ``Trainer.save_resume_state`` / ``try_resume`` on STAR
  (batch statistics): params, Adam slots, statistics, step, the base dropout
  seed, both torch generators, ``np_rng``, the early stop and the extra
  trees come back bit-equal; the JAX package's ``load_pytree`` reads the
  params / statistics / step subtree of the port's ``train_state.npz`` with
  JAX templates.
- MAMDR's fused route with dropout on: 1 epoch, then a fresh trainer
  resumed to 3, bit-equal to an unbroken 3-epoch run — every leaf of the
  state, shared, specific, the best snapshot, ``np_rng`` and the run()'s
  test and finetune results. MAMDR's epoch draws its sequence anew, so its
  resume has nothing to lose.
- The other routes that resume (joint fused and per-call, DN, Reptile, MAML,
  MLDG): the JAX package's resume restarts the in-place shuffled domain
  ``sequence`` from its unshuffled order (ROADMAP.md §3), so a resumed run
  is held to the JAX package's resumed run, both from one start by
  ``test_torch_loops.loop_pair`` (one batch a domain where a fused pass
  shuffles): the epoch it starts at, ``np_rng``'s state after, the early
  stop, and the test split with the state's params (loss rtol 1e-4, AUC abs
  1e-5).
- A resumed DN, Reptile or MAML ``run()`` does what the JAX package's does:
  with no improving resumed epoch and a new timestamped checkpoint folder,
  both raise ``FileNotFoundError`` at the test; within the same second both
  test the first process's best checkpoint alike (ROADMAP.md §3).
- ``save_decomposition`` read back by the port's ``load_decomposition`` and
  the JAX package's, with full and masked-only specific files.
- PCGrad and a meta ``_train_loop`` write no snapshot, as in the JAX
  package; ``resume`` with no snapshot starts at epoch 0; ``--resume`` on
  the CLI.
"""

import json

import jax
import numpy as np
import pytest
import torch

from mamdr_tpu.config import ExperimentConfig as JConfig
from mamdr_tpu.data.synthetic import make_synthetic_dataset as jax_make_synthetic
from mamdr_tpu.train.checkpoints import load_decomposition as jload_decomposition
from mamdr_tpu.train.checkpoints import load_pytree as jload_pytree
from mamdr_tpu.train.trainer import Trainer as JTrainer
from mamdr_tpu_torch import run
from mamdr_tpu_torch.config import ExperimentConfig
from mamdr_tpu_torch.data.synthetic import make_synthetic_dataset
from mamdr_tpu_torch.strategies.base import build_strategy
from mamdr_tpu_torch.train import checkpoints
from mamdr_tpu_torch.train.trainer import Trainer
from mamdr_tpu_torch.utils import trees
from test_torch_loops import loop_pair
from test_torch_strategies import results_close


def config(tmp_path, name, epochs, model=None, **train):
    return {
        "model": {"name": name, "user_dim": 8, "item_dim": 8, "domain_dim": 8,
                  "hidden_dim": [16, 8], "dropout": 0.3, **(model or {})},
        "train": {"epoch": epochs, "learning_rate": 0.01, "patience": 5, "sample_num": 1,
                  "meta_learning_rate": 0.1, "load_pretrain_emb": True, "emb_trainable": False,
                  "checkpoint_path": str(tmp_path / "ckpt"),
                  "result_save_path": str(tmp_path / "result"), **train},
        "dataset": {"name": "synthetic", "batch_size": 64, "seed": 5},
    }


def dataset(make=make_synthetic_dataset):
    ds = make(n_domain=3, n_uid=50, n_pid=50, n_per_domain=300, seed=5, batch_size=64)
    r = np.random.default_rng(0)
    ds.user_emb = r.normal(0, 0.1, (50, 8)).astype(np.float32)
    ds.item_emb = r.normal(0, 0.1, (50, 8)).astype(np.float32)
    return ds


def port_strategy(tmp_path, name, epochs, model=None, **train):
    cfg = ExperimentConfig.from_dict(config(tmp_path, name, epochs, model, **train))
    return build_strategy(Trainer(cfg, dataset(), device="cpu", verbose=False))


def assert_trees_equal(a, b, what):
    assert trees.param_names(a) == trees.param_names(b), what
    for (n, x), y in zip(trees.leaves_with_names(a), trees.leaves(b)):
        assert torch.equal(x, y), f"{what}: {n}"


STAR = {"hidden_dim": [16, 8], "auxiliary_dim": 8, "norm": "pn", "dense": "star",
        "dropout": 0.0}


def test_train_state_round_trip(tmp_path):
    t = port_strategy(tmp_path, "star", 1, STAR, resume_every=1).trainer
    t.state, _ = t.fit_domain(t.state, 0)
    assert t.state.batch_stats and int(t.state.opt_state.count) > 0
    t.stopper.step(0.6)
    t.stopper.step(0.5)
    t.draw_seed()
    torch.rand(3, generator=t.gen)
    t.np_rng.random(7)
    extra = {"best_params": t.state.params, "meta_opt": t.state.opt_state}
    t.save_resume_state(3, extra_trees=extra)
    assert checkpoints.has_train_state(t.resume_dir)

    t2 = port_strategy(tmp_path, "star", 1, STAR, resume=True).trainer
    assert t2.resume_dir == t.resume_dir
    start, extras = t2.try_resume({"best_params": t2.state.params,
                                   "meta_opt": t2.state.opt_state})
    assert start == 4
    for name in ("params", "batch_stats"):
        assert_trees_equal(getattr(t2.state, name), getattr(t.state, name), name)
    for k in ("count", "mu", "nu"):
        assert torch.equal(getattr(t2.state.opt_state, k), getattr(t.state.opt_state, k))
        assert torch.equal(getattr(extras["meta_opt"], k), getattr(t.state.opt_state, k))
    assert_trees_equal(extras["best_params"], t.state.params, "best_params")
    assert torch.equal(t2.state.step, t.state.step) and t2.state.seed == t.state.seed
    assert t2.draw_seed() == t.draw_seed()
    assert torch.equal(torch.rand(5, generator=t2.gen), torch.rand(5, generator=t.gen))
    assert t2.np_rng.bit_generator.state == t.np_rng.bit_generator.state
    for k in ("patience", "counter", "best_metric", "early_stop"):
        assert getattr(t2.stopper, k) == getattr(t.stopper, k), k
    assert (t2.stopper.counter, t2.stopper.best_metric) == (1, 0.6)

    # the JAX package reads the params / statistics / step subtree
    jcfg = JConfig.from_dict(config(tmp_path / "jax", "star", 1, STAR))
    jt = JTrainer(jcfg, dataset(jax_make_synthetic), verbose=False)
    tmpl = {"params": jt.state.params, "batch_stats": jt.state.batch_stats,
            "step": jt.state.step}
    loaded = jload_pytree(f"{t.resume_dir}/train_state.npz", tmpl)
    for what in ("params", "batch_stats"):
        port = dict(trees.leaves_with_names(getattr(t.state, what)))
        jnames = trees.param_names(jax.device_get(loaded[what]))
        assert sorted(jnames) == sorted(port)
        for n, leaf in zip(jnames, jax.tree_util.tree_leaves(loaded[what])):
            assert np.array_equal(np.asarray(leaf), port[n].numpy()), n
    assert int(loaded["step"]) == int(t.state.step)


def test_mamdr_resume_equals_unbroken(tmp_path):
    """1 epoch + resume to 3 against 3 unbroken epochs, dropout 0.3."""
    a = port_strategy(tmp_path / "a", "mlp_meta_mamdr_finetune", 3)
    assert a.use_fused
    res_a = a.run()
    b = port_strategy(tmp_path / "bc", "mlp_meta_mamdr_finetune", 1, resume_every=1)
    b.train()
    c = port_strategy(tmp_path / "bc", "mlp_meta_mamdr_finetune", 3, resume=True)
    starts = spy_starts(c.trainer)
    res_c = c.run()
    assert starts == [1]
    assert res_c == res_a
    ta, tc = a.trainer, c.trainer
    for what in ("params", "batch_stats"):
        assert_trees_equal(getattr(tc.state, what), getattr(ta.state, what), what)
    for k in ("count", "mu", "nu"):
        assert torch.equal(getattr(tc.state.opt_state, k), getattr(ta.state.opt_state, k))
    assert torch.equal(tc.state.step, ta.state.step) and tc.state.seed == ta.state.seed
    assert_trees_equal(c.shared, a.shared, "shared")
    assert_trees_equal(c.best_shared, a.best_shared, "best_shared")
    for d in range(3):
        assert_trees_equal(c.specific[d], a.specific[d], f"specific[{d}]")
        assert_trees_equal(c.best_specific[d], a.best_specific[d], f"best_specific[{d}]")
    assert tc.np_rng.bit_generator.state == ta.np_rng.bit_generator.state
    assert tc.stopper.best_metric == ta.stopper.best_metric


ROUTES = {
    "joint_fused": ("mlp", False, {}),
    "joint_loop": ("mlp", True, {}),
    "dn": ("mlp_meta_domain_negotiation_finetune", False, {}),
    "reptile": ("mlp_meta_reptile_finetune", False, {}),
    "maml": ("mlp_meta_maml_finetune", False,
             {"meta_split": "meta-train/val", "meta_split_ratio": 0.5}),
    "mldg": ("mlp_meta_mldg_finetune", False,
             {"meta_split": "meta-train/val", "meta_split_ratio": 0.5}),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_resume_matches_jax_resume(tmp_path, route):
    """1 epoch with the snapshot, then a fresh pair resumed to 2 epochs, in
    both packages from one start: the same start epoch and np_rng state, the
    early stop and the state's test results within loss rtol 1e-4 / AUC abs
    1e-5. 60 train rows a domain, batch 64: one batch a domain, so the fused
    passes' shuffles (threefry and torch) permute the same rows."""
    name, fixed, train = ROUTES[route]
    kw = dict(n_per_domain=100, fixed_train=fixed, meta_learning_rate=0.05, **train)
    jt, js, tt, ts = loop_pair(tmp_path, name, epoch=1, resume_every=1, **kw)
    assert tt.fused_padding_ok(ragged=True) != fixed
    js.train()
    ts.train()
    assert checkpoints.has_train_state(tt.resume_dir)
    jt, js, tt, ts = loop_pair(tmp_path, name, epoch=2, resume=True, **kw)
    j_starts, t_starts = spy_starts(jt), spy_starts(tt)
    js.train()
    ts.train()
    assert t_starts == j_starts == [1]
    assert tt.np_rng.bit_generator.state == jt.np_rng.bit_generator.state
    assert tt.stopper.counter == jt.stopper.counter
    assert tt.stopper.best_metric == pytest.approx(jt.stopper.best_metric, abs=1e-5)
    results_close(tt.val_and_test("test", params=tt.state.params),
                  jt.val_and_test("test", params=jt.state.params))


@pytest.mark.parametrize("route,same_second", [
    ("dn", False), ("reptile", False), ("maml", False), ("dn", True)])
def test_resumed_meta_run_matches_jax(tmp_path, monkeypatch, route, same_second):
    """A meta strategy's snapshot carries no best weights, so its resumed
    ``run()`` tests the best checkpoint in its own process's timestamped
    folder. The clock is pinned for each process, and the resumed epoch runs
    at learning rates 0, so it cannot improve: in a new second both packages
    raise ``FileNotFoundError``; in the same second both test the first
    process's checkpoint, within loss rtol 1e-4 / AUC abs 1e-5."""
    name, _, train = ROUTES[route]
    kw = dict(n_per_domain=100, **train)
    monkeypatch.setattr("time.strftime", lambda fmt, *a: "20260101-000000")
    jt, js, tt, ts = loop_pair(tmp_path, name, epoch=1, resume_every=1, **kw)
    js.train()
    ts.train()
    if not same_second:
        monkeypatch.setattr("time.strftime", lambda fmt, *a: "20260101-000001")
    jt, js, tt, ts = loop_pair(tmp_path, name, epoch=2, resume=True, learning_rate=0.0,
                               meta_learning_rate=0.0, **kw)
    assert (tt.checkpoint_dir.endswith("000000"), jt.checkpoint_dir.endswith("000000")) == (
        same_second, same_second)
    j_starts, t_starts = spy_starts(jt), spy_starts(tt)
    if same_second:
        results_close(ts.run(), js.run())
    else:
        with pytest.raises(FileNotFoundError):
            js.run()
        with pytest.raises(FileNotFoundError):
            ts.run()
    assert t_starts == j_starts == [1]
    assert tt.stopper.counter == jt.stopper.counter == 1  # the resumed epoch did not improve


@pytest.mark.parametrize("masked", [True, False])
def test_decomposition_read_by_both_loaders(tmp_path, masked):
    """``save_decomposition`` of distinct specific trees, read back by the
    port's loader and the JAX package's: shared, every specific and the meta
    equal. Masked-only files hold just the masked leaves; the port's loader
    takes the others from shared, the very tensors."""
    s = port_strategy(tmp_path, "mlp_meta_mamdr_finetune", 1)
    gen = torch.Generator().manual_seed(3)
    specific = [trees.named_tree_map(
        lambda n, x, m: x + 0.01 * (d + 1) * torch.randn(x.shape, generator=gen)
        if bool(m) else x, s.shared, s.mask) for d in range(3)]
    d = str(tmp_path / "decomposition")
    checkpoints.save_decomposition(d, s.shared, specific, extra={"merged_method": "plus"},
                                   mask=s.mask if masked else None)
    with np.load(d + "/specific_0.npz") as z:
        kept = {n for n, m in trees.leaves_with_names(s.mask) if bool(m) or not masked}
        assert {k.replace("//", "/") for k in z.files} == kept
        assert masked == (kept != set(trees.param_names(s.shared)))

    shared, spec, meta = checkpoints.load_decomposition(d, s.trainer.state.params)
    assert meta == {"n_domain": 3, "masked_only": masked, "merged_method": "plus"}
    assert_trees_equal(shared, s.shared, "shared")
    for i in range(3):
        assert_trees_equal(spec[i], specific[i], f"specific[{i}]")
        if masked:
            for (n, m), x, y in zip(trees.leaves_with_names(s.mask), trees.leaves(spec[i]),
                                    trees.leaves(shared)):
                assert bool(m) or x is y, n

    jshared, jspec, jmeta = jload_decomposition(
        d, trees.tree_map(lambda x: x.numpy(), s.trainer.state.params))
    assert jmeta == meta
    for what, port, jax_tree in [("shared", s.shared, jshared)] + [
            (f"specific[{i}]", specific[i], jspec[i]) for i in range(3)]:
        jleaves = dict(zip(trees.param_names(jax_tree), jax.tree_util.tree_leaves(jax_tree)))
        assert sorted(jleaves) == trees.param_names(port), what
        for n, x in trees.leaves_with_names(port):
            assert np.array_equal(np.asarray(jleaves[n]), x.numpy()), f"{what}: {n}"


@pytest.mark.parametrize("name,train", [
    ("mlp_pcgrad", {}),  # the fused route
    ("mlp_meta_reptile_finetune", {"target_domain": 1}),  # a meta _train_loop
])
def test_routes_that_do_not_resume(tmp_path, name, train):
    """No snapshot where the JAX package writes none."""
    s = port_strategy(tmp_path, name, 1, resume_every=1, **train)
    s.train()
    assert not checkpoints.has_train_state(s.trainer.resume_dir)


def test_resume_without_snapshot_starts_at_epoch_0(tmp_path):
    s = port_strategy(tmp_path, "mlp", 2, resume=True, resume_every=1)
    starts = spy_starts(s.trainer)
    s.train()
    assert starts == [None] and s.trainer._eval_epoch_counter == 2
    assert checkpoints.has_train_state(s.trainer.resume_dir)


def test_cli_resume(tmp_path, capsys):
    """--resume: the first call finds no snapshot and writes one every epoch
    (resume_every 0 -> 1); the second, with 2 epochs, resumes at epoch 1.
    Joint, whose snapshot carries the best weights: a resumed meta strategy
    tests the best checkpoint of its own process, which exists only once a
    resumed epoch improves, as in the JAX package (ROADMAP.md §3)."""
    path = tmp_path / "c.json"
    for epochs in (1, 2):
        cfg = config(tmp_path, "mlp", epochs)
        path.write_text(json.dumps(cfg))
        avg_loss, avg_auc, _, _ = run.cli(["--config", str(path), "--resume", "--device", "cpu"])
        assert np.isfinite(avg_loss) and 0.0 <= avg_auc <= 1.0
        out = capsys.readouterr().out
        resume_dir = tmp_path / "ckpt" / "mlp" / "synthetic" / "split_by_category"
        assert ("Resumed from" in out) == (epochs == 2), out[-2000:]
        assert checkpoints.has_train_state(str(resume_dir / "resume"))
    assert f"Resumed from {resume_dir / 'resume'} at epoch 1" in out
    assert "Epoch: 1" in out and "Epoch: 0" not in out


def spy_starts(trainer):
    """The epochs each ``try_resume`` call of ``trainer`` returned (None: no
    snapshot taken up)."""
    starts = []
    fn = trainer.try_resume

    def spy(*a, **k):
        r = fn(*a, **k)
        starts.append(None if r is None else r[0])
        return r

    trainer.try_resume = spy
    return starts
