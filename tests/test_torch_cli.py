"""The port's command line, config loading and benchmark corpus vs the JAX
package's.

- ``load_config`` of a written JSON equals the JAX package's, field for field;
- ``list_configs()`` equals the JAX package's, and every entry's
  ``benchmark_config(...).to_dict()`` equals the JAX one on every field but
  those in ``OMITTED`` (each with its reason);
- ``run.main(cfg, device="cpu")`` against ``mamdr_tpu.run.main(cfg)`` on a
  small file tree (Taobao layout, pretrained emb JSON) for ``mlp`` and
  ``mlp_meta_mamdr_finetune``: both packages start from the same parameters
  (and MAMDR from the same specific weights), dropout off, one batch a
  domain (tests/test_torch_strategies.py). Per-domain test loss within rtol
  1e-4, AUC within abs 1e-5; ``result.json`` so, ``dataset_info.json`` and
  ``config.json.example`` equal, ``model_parameters.npz`` with the same flax
  names and shapes and read by the JAX package's ``load_pytree``;
- one subprocess of ``python -m mamdr_tpu_torch.run --config ... --device cpu``;
- corpus entries refused before their base model was ported now run on a
  small tree (``--resume``: tests/test_torch_resume.py); and without a card,
  the CLI raises unless told ``--device cpu``.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from mamdr_tpu import benchmarks as jbenchmarks
from mamdr_tpu import run as jrun
from mamdr_tpu.config import load_config as jload_config
from mamdr_tpu.strategies import build_strategy as jbuild_strategy
from mamdr_tpu.train import checkpoints as jcheckpoints
from mamdr_tpu.train.trainer import Trainer as JTrainer
from mamdr_tpu_torch import benchmarks, run
from mamdr_tpu_torch.config import load_config
from mamdr_tpu_torch.convert import params_from_jax, specific_from_jax
from mamdr_tpu_torch.data.synthetic import make_synthetic_dataset
from mamdr_tpu_torch.strategies.base import build_strategy
from mamdr_tpu_torch.train.trainer import Trainer
from mamdr_tpu_torch.workload import write_domain_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Fields of the JAX package's config that the port leaves out, and why.
OMITTED = {}


def jax_dict(cfg):
    d = cfg.to_dict()
    for block, fields in OMITTED.items():
        for f in fields:
            d[block].pop(f)
    return d


def test_load_config_equals_jax(tmp_path):
    path = tmp_path / "c.json"
    path.write_text(json.dumps({
        "model": {"name": "mlp_meta_reptile_batch_finetune", "hidden_dim": [64, 32],
                  "dropout": 0.25, "num_experts": 7, "unknown_key": 1},
        "train": {"epoch": 5, "meta_train_step": 3, "meta_sequence": [2, 0, 1],
                  "result_save_path": "out", "profile_dir": "p"},
        "dataset": {"name": "Taobao", "dataset_path": "/data/t", "shuffle_buffer_size": 7,
                    "num_parallel_reads": 2, "fixed_train": False},
    }))
    got, want = load_config(str(path)), jload_config(str(path))
    assert got.to_dict() == jax_dict(want)
    assert dataclasses.astuple(got.spec) == dataclasses.astuple(want.spec)


def test_list_configs_equals_jax():
    assert benchmarks.list_configs() == jbenchmarks.list_configs()
    assert benchmarks.MODEL_VARIANTS == jbenchmarks.MODEL_VARIANTS
    assert benchmarks.BENCHMARK_DATASETS == jbenchmarks.BENCHMARK_DATASETS


@pytest.mark.parametrize("entry", jbenchmarks.list_configs())
def test_benchmark_config_equals_jax(entry):
    bench, _, model = entry.partition("/")
    assert benchmarks.benchmark_config(bench, model).to_dict() == jax_dict(
        jbenchmarks.benchmark_config(bench, model))


def _tree(root, n_domain=3, emb_dim=8, n_per_domain=100):
    """A small Taobao tree (at most 64 train rows a domain) -> its path."""
    ds = make_synthetic_dataset(n_domain=n_domain, n_uid=50, n_pid=60,
                                n_per_domain=n_per_domain, seed=21, long_tail=True)
    rng = np.random.default_rng(0)
    ds.user_emb = rng.normal(0, 0.1, (50, emb_dim)).astype(np.float32)
    ds.item_emb = rng.normal(0, 0.1, (60, emb_dim)).astype(np.float32)
    ds.ctr_ratio = {1: 0.4}
    write_domain_tree(ds, str(root))
    return str(root)


def _config(tree, name):
    return {
        "model": {"name": name, "user_dim": 8, "item_dim": 8, "domain_dim": 8,
                  "hidden_dim": [32, 16], "dropout": 0.0},
        "train": {"load_pretrain_emb": True, "emb_trainable": False, "learning_rate": 1e-2,
                  "meta_learning_rate": 0.1, "sample_num": 2, "epoch": 3, "patience": 2,
                  "checkpoint_path": "ckpt", "result_save_path": "result"},
        "dataset": {"name": "Taobao", "dataset_path": os.path.dirname(tree),
                    "domain_split_path": os.path.basename(tree), "batch_size": 64,
                    "seed": 21},
    }


def _result_folder(root, cfg):
    base = os.path.join(root, "result", cfg["model"]["name"], "Taobao",
                        cfg["dataset"]["domain_split_path"])
    (folder,) = os.listdir(base)
    path = os.path.join(base, folder)
    assert sorted(os.listdir(path)) == ["config.json.example", "dataset_info.json",
                                        "model_parameters.npz", "result.json"]
    return path, folder


def _read(folder, name):
    with open(os.path.join(folder, name)) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ["mlp", "mlp_meta_mamdr_finetune"])
def test_main_matches_jax_on_a_file_tree(tmp_path, monkeypatch, name):
    tree = _tree(tmp_path / "data" / "split_t")
    cfg = _config(tree, name)
    path = tmp_path / "c.json"
    path.write_text(json.dumps(cfg))
    start = {}

    class JT(JTrainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            start["params"] = jax.device_get(self.state.params)

    def jbuild(t):
        s = jbuild_strategy(t)
        if hasattr(s, "specific"):
            start["specific"] = jax.device_get(s.specific)
        return s

    class TT(Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.state = self.state.replace(params=params_from_jax(start["params"]))

    def tbuild(t):
        s = build_strategy(t)
        if "specific" in start:
            s.specific = specific_from_jax(start["specific"], s.mask, s.shared)
            s.best_specific = list(s.specific)
        return s

    monkeypatch.setattr(jrun, "Trainer", JT)
    monkeypatch.setattr(jrun, "build_strategy", jbuild)
    monkeypatch.setattr(run, "Trainer", TT)
    monkeypatch.setattr(run, "build_strategy", tbuild)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    jres = jrun.main(jload_config(str(path)), verbose=False)
    monkeypatch.chdir(tmp_path / "port")
    tres = run.main(load_config(str(path)), verbose=False, device="cpu")

    _, _, jdl, jda = jres
    _, _, tdl, tda = tres
    np.testing.assert_allclose([tdl[k] for k in jdl], [jdl[k] for k in jdl], rtol=1e-4)
    np.testing.assert_allclose([tda[k] for k in jda], [jda[k] for k in jda], rtol=0, atol=1e-5)
    jfolder, _ = _result_folder(tmp_path / "jax", cfg)
    tfolder, tname = _result_folder(tmp_path / "port", cfg)
    assert tname.startswith("loss_{:.3f}_auc_{:.3f}_".format(tres[0], tres[1]))
    jr, tr = _read(jfolder, "result.json"), _read(tfolder, "result.json")
    assert sorted(tr) == sorted(jr) == ["avg_auc", "avg_loss", "domain_auc", "domain_loss"]
    assert tr["domain_loss"] == tdl and tr["domain_auc"] == tda
    np.testing.assert_allclose([tr["avg_loss"], tr["avg_auc"]], [jr["avg_loss"], jr["avg_auc"]],
                               rtol=1e-4, atol=1e-5)
    assert _read(tfolder, "dataset_info.json") == _read(jfolder, "dataset_info.json")
    assert _read(tfolder, "dataset_info.json")["1"]["ctr_ratio"] == 0.4
    want_cfg = _read(jfolder, "config.json.example")
    for block, fields in OMITTED.items():
        for f in fields:
            want_cfg[block].pop(f)
    assert _read(tfolder, "config.json.example") == want_cfg
    with np.load(os.path.join(tfolder, "model_parameters.npz")) as t, \
            np.load(os.path.join(jfolder, "model_parameters.npz")) as j:
        assert sorted(t.files) == sorted(j.files)
        assert "model//dnn//Dense_0//Dense_0//kernel" in t.files
        assert all(t[k].shape == j[k].shape and t[k].dtype == j[k].dtype for k in j.files)
    loaded = jcheckpoints.load_pytree(os.path.join(tfolder, "model_parameters.npz"),
                                      jax.device_get(start["params"]))
    assert all(np.all(np.isfinite(x)) for x in jax.tree_util.tree_leaves(loaded))


def test_cli_subprocess_on_the_cpu(tmp_path):
    cfg = {
        "model": {"name": "mlp_meta_reptile_finetune", "user_dim": 4, "item_dim": 4,
                  "domain_dim": 4, "hidden_dim": [8], "dropout": 0.5},
        "train": {"epoch": 2, "checkpoint_path": str(tmp_path / "ckpt"),
                  "result_save_path": str(tmp_path / "result")},
        "dataset": {"name": "synthetic", "batch_size": 32, "n_domain": 2, "n_uid": 20,
                    "n_pid": 20, "n_per_domain": 128},
    }
    path = tmp_path / "c.json"
    path.write_text(json.dumps(cfg))
    env = {**os.environ, "PYTHONPATH": REPO}
    p = subprocess.run([sys.executable, "-m", "mamdr_tpu_torch.run", "--config", str(path),
                        "--device", "cpu"], capture_output=True, text=True, env=env,
                       cwd=str(tmp_path), timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "Test Result:" in p.stdout and "Finetune:" in p.stdout
    base = tmp_path / "result" / "mlp_meta_reptile_finetune" / "synthetic" / "split_by_category"
    (folder,) = os.listdir(base)
    result = json.loads((base / folder / "result.json").read_text())
    assert np.isfinite(result["avg_loss"]) and 0.0 <= result["avg_auc"] <= 1.0


def test_list_benchmarks_prints_the_corpus(capsys):
    assert run.cli(["--list-benchmarks"]) is None
    assert capsys.readouterr().out.split() == jbenchmarks.list_configs()


CLI_REFUSED = [
    (["--benchmark", "Taobao-10/deepfm"], None),  # lifted: ported, it runs
    (["--benchmark", "Taobao-10/star_meta_mamdr_finetune"], None),  # lifted: ported, it runs
    (["--benchmark", "Taobao-10/mmoe"], None),  # lifted: ported, it runs
    (["--benchmark", "Taobao-10/star"], None),  # lifted: ported, it runs
]


@pytest.mark.parametrize("argv,item", CLI_REFUSED)
def test_cli_refusals_name_their_item(tmp_path, monkeypatch, argv, item):
    """A refused corpus entry raises naming its item; one whose item is None
    was refused before its base model was ported and now runs on the small
    tree to its result folder."""
    # the corpus's relative dataset_path, with a small tree of 128-d tables
    _tree(tmp_path / "dataset" / "Taobao" / "split_by_theme_10", n_domain=2, emb_dim=128)
    monkeypatch.chdir(tmp_path)
    if item is None:
        run.cli(argv + ["--device", "cpu"])
        name = argv[1].split("/")[1]
        base = tmp_path / "result" / name / "Taobao" / "split_by_theme_10"
        (folder,) = os.listdir(base)
        result = json.loads((base / folder / "result.json").read_text())
        assert sorted(result["domain_auc"]) == ["0", "1"]
        assert np.isfinite(result["avg_loss"]) and 0.0 <= result["avg_auc"] <= 1.0
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md, open items §1: {item}"):
        run.cli(argv + ["--device", "cpu"])


def test_cli_needs_the_card_unless_told_cpu(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the rule under test is the no-card case")
    _tree(tmp_path / "dataset" / "Taobao" / "split_by_theme_10", n_domain=2, emb_dim=128)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run.cli(["--benchmark", "Taobao-10/mlp"])
