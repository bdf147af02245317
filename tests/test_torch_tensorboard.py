"""TensorBoard in the port (utils/logging.py ``TensorBoardLogger`` and its
on-device ``histogram``, the trainer's writes, utils/tb_export.py) vs the
JAX package's; both write through ``torch.utils.tensorboard.SummaryWriter``.

Both packages' event files are read with TensorBoard's own
``EventAccumulator``:

- the trainer's ``summarize`` on a val and a test evaluation with the same
  per-domain numbers and the same parameters gives the same scalar tags,
  steps and values (float32 both sides), the same weight histograms (bucket
  limits and counts equal, min / max / num equal, sum and sum of squares at
  rtol 1e-12: float64 sums in another order) and the same ``grad/``
  histograms, whose gradients (``_sample_grads``: the whole tree, frozen
  tables included) are held leaf by leaf to the JAX ``_sample_grads`` at
  rtol 2e-5 before their histograms are compared;
- ``histogram_freq`` is honoured (histograms every N val epochs), scalars
  only with ``tensorboard`` alone, and nothing at all by default;
- a whole ``run()`` with TensorBoard on writes every evaluation's scalars
  equal to its ``metrics.jsonl`` values;
- ``tb_export`` of a metrics.jsonl the JAX package wrote equals the JAX
  exporter's scalars, wall times included;
- ``histogram`` (the buckets counted on the tensor's device) equals
  SummaryWriter's own ``make_histogram`` with ``bins="tensorflow"``;
- a run without TensorBoard never imports ``torch.utils.tensorboard``.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

from mamdr_tpu.config import ExperimentConfig as JConfig
from mamdr_tpu.data.synthetic import make_synthetic_dataset as jax_make_synthetic
from mamdr_tpu.train.trainer import Trainer as JTrainer
from mamdr_tpu.utils import tb_export as jtb_export
from mamdr_tpu.utils import trees as jtrees
from mamdr_tpu.utils.logging import MetricsLogger as JMetricsLogger
from mamdr_tpu_torch.config import ExperimentConfig
from mamdr_tpu_torch.convert import params_from_jax
from mamdr_tpu_torch.data.synthetic import make_synthetic_dataset
from mamdr_tpu_torch.strategies.base import build_strategy
from mamdr_tpu_torch.train.trainer import Trainer
from mamdr_tpu_torch.utils import tb_export, trees
from mamdr_tpu_torch.utils.logging import TensorBoardLogger, histogram


def _config(tmp_path, side, emb_trainable=False, **train):
    return {
        "model": {"name": "mlp_meta_mamdr_finetune", "user_dim": 8, "item_dim": 8,
                  "domain_dim": 8, "hidden_dim": [16, 8], "dropout": 0.0},
        "train": {"load_pretrain_emb": True, "emb_trainable": emb_trainable, "epoch": 1,
                  "checkpoint_path": str(tmp_path / side / "ckpt"),
                  "result_save_path": str(tmp_path / side / "result"), **train},
        "dataset": {"name": "synthetic", "batch_size": 32, "seed": 5},
    }


def _pair(tmp_path, emb_trainable=False, **train):
    """A JAX and a port trainer on the same data and parameters."""
    kw = dict(n_domain=3, n_uid=40, n_pid=50, n_per_domain=96, seed=5, batch_size=32)
    jds, tds = jax_make_synthetic(**kw), make_synthetic_dataset(**kw)
    for ds in (jds, tds):
        rng = np.random.default_rng(1)
        ds.user_emb = rng.normal(0, 0.1, (40, 8)).astype(np.float32)
        ds.item_emb = rng.normal(0, 0.1, (50, 8)).astype(np.float32)
    jt = JTrainer(JConfig.from_dict(_config(tmp_path, "jax", emb_trainable, **train)), jds,
                  verbose=False)
    tt = Trainer(ExperimentConfig.from_dict(_config(tmp_path, "port", emb_trainable, **train)),
                 tds, device="cpu", verbose=False)
    tt.state = tt.state.replace(params=params_from_jax(jax.device_get(jt.state.params)))
    return jt, tt


def _accumulator(logdir):
    acc = EventAccumulator(logdir, size_guidance={"scalars": 0, "histograms": 0})
    acc.Reload()
    return acc


def _histograms_equal(a, b, what, rtol):
    """Steps, bucket limits, counts and num equal; min / max equal within
    ``rtol`` (0 for weights, the gradients' 2e-5 for ``grad/``), sum and sum
    of squares within ``rtol`` or 1e-12 (float64 sums in another order)."""
    assert a.step == b.step, what
    ha, hb = a.histogram_value, b.histogram_value
    assert list(ha.bucket_limit) == list(hb.bucket_limit), what
    assert list(ha.bucket) == list(hb.bucket), what
    assert ha.num == hb.num, what
    np.testing.assert_allclose([ha.min, ha.max], [hb.min, hb.max], rtol=rtol, atol=0,
                               err_msg=what)
    np.testing.assert_allclose([ha.sum, ha.sum_squares], [hb.sum, hb.sum_squares],
                               rtol=max(rtol, 1e-12), atol=1e-12, err_msg=what)


@pytest.mark.parametrize("emb_trainable", [False, True])
def test_summarize_writes_what_the_jax_trainer_writes(tmp_path, emb_trainable):
    jt, tt = _pair(tmp_path, emb_trainable, histogram_freq=1, write_grads=True)
    assert tt.tb.enabled and tt.tb.write_grads
    # the sample gradients, leaf by leaf, before their histograms
    jg = dict(zip(jtrees.param_names(jax.device_get(jt.state.params)),
                  jax.tree_util.tree_leaves(jt._sample_grads())))
    tg = tt._sample_grads()
    assert trees.param_names(tg) == list(jg)
    for n, g in trees.leaves_with_names(tg):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[n]), rtol=2e-5, atol=1e-9,
                                   err_msg=n)
    rows = int((tg["model"]["embedding"]["user_emb"] != 0).any(dim=1).sum())
    # a frozen table's gradient is the gather's alone: the sample's rows; a
    # trainable one has the l2 term's on every row
    assert 0 < rows <= 2 if not emb_trainable else rows == 40

    loss = {"0": 0.61, "1": 0.65, "2": 0.7}
    auc = {"0": 0.55, "1": 0.6123456789, "2": 0.5}
    for mode in ("val", "test", "val"):
        jt.summarize(mode, dict(loss), dict(auc))
        tt.summarize(mode, dict(loss), dict(auc))
    ja = _accumulator(os.path.join(jt.checkpoint_dir, "tensorboard"))
    ta = _accumulator(os.path.join(tt.checkpoint_dir, "tensorboard"))
    assert sorted(ta.Tags()["scalars"]) == sorted(ja.Tags()["scalars"])
    assert "val/weighted_auc" in ta.Tags()["scalars"]
    for tag in ja.Tags()["scalars"]:
        assert ([(e.step, e.value) for e in ta.Scalars(tag)]
                == [(e.step, e.value) for e in ja.Scalars(tag)]), tag
    names = trees.param_names(tt.state.params)
    assert sorted(ta.Tags()["histograms"]) == sorted(ja.Tags()["histograms"]) == sorted(
        names + [f"grad/{n}" for n in names])
    for tag in ja.Tags()["histograms"]:
        jh, th = ja.Histograms(tag), ta.Histograms(tag)
        assert [h.step for h in th] == [0, 1], tag  # every val epoch
        for a, b in zip(th, jh):
            _histograms_equal(a, b, tag, 2e-5 if tag.startswith("grad/") else 0.0)


def test_histogram_freq_and_the_defaults(tmp_path):
    tree = {"w": torch.arange(6.0).reshape(2, 3), "b": torch.zeros(3)}
    every2 = TensorBoardLogger(str(tmp_path / "f2"), histogram_freq=2, write_grads=True)
    for epoch in range(5):
        every2.log_histograms(epoch, tree)
        every2.log_grad_histograms(epoch, tree)
    every2.close()
    acc = _accumulator(str(tmp_path / "f2"))
    assert sorted(acc.Tags()["histograms"]) == ["b", "grad/b", "grad/w", "w"]
    assert all([h.step for h in acc.Histograms(t)] == [0, 2, 4]
               for t in acc.Tags()["histograms"])
    assert acc.Histograms("w")[0].histogram_value.num == 6.0

    scalars_only = TensorBoardLogger(str(tmp_path / "s"), enabled=True, write_grads=True)
    assert scalars_only.enabled and not scalars_only.write_grads
    scalars_only.log_histograms(0, tree)
    scalars_only.log_eval("val", 0, 0.5, 0.6, {"0": 0.6})
    acc = _accumulator(str(tmp_path / "s"))
    assert acc.Tags()["histograms"] == [] and sorted(acc.Tags()["scalars"]) == [
        "val/avg_auc", "val/avg_loss", "val/domain_0_AUC"]

    off = TensorBoardLogger(str(tmp_path / "off"), write_grads=True)
    off.log_eval("val", 0, 0.5, 0.6, {"0": 0.6})
    off.log_histograms(0, tree)
    assert not off.enabled and not os.path.exists(tmp_path / "off")
    with pytest.raises(ValueError, match="logdir"):
        TensorBoardLogger(None, histogram_freq=1)

    _, tt = _pair(tmp_path)  # TensorBoard is off by default
    assert not tt.tb.enabled
    tt.summarize("val", {"0": 0.6}, {"0": 0.6})
    assert not os.path.exists(os.path.join(tt.checkpoint_dir, "tensorboard"))


def test_run_writes_every_evaluation(tmp_path):
    """A whole MAMDR run() with TensorBoard on: one histogram a leaf and a
    grad/ histogram a leaf on each val epoch, every scalar equal to the
    metrics.jsonl event's value."""
    _, tt = _pair(tmp_path, histogram_freq=1, write_grads=True, epoch=2)
    build_strategy(tt).run()
    acc = _accumulator(os.path.join(tt.checkpoint_dir, "tensorboard"))
    scalars = {t: [(e.step, e.value) for e in acc.Scalars(t)] for t in acc.Tags()["scalars"]}
    with open(os.path.join(tt.checkpoint_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    n_checked = 0
    seen = {}
    for rec in records:
        if not rec["event"].endswith("_eval"):
            continue
        mode = rec["event"][:-5]
        values = {"avg_loss": rec["avg_loss"], "avg_auc": rec["avg_auc"],
                  **{f"domain_{k}_AUC": v for k, v in rec["domain_auc"].items()}}
        for name, v in values.items():
            tag = f"{mode}/{name}"
            i = seen.get(tag, 0)
            seen[tag] = i + 1
            step, got = scalars[tag][i]
            assert step == rec["epoch"] and got == np.float32(v), tag
            n_checked += 1
    assert n_checked == sum(len(v) for k, v in scalars.items()
                            if not k.endswith("weighted_auc"))
    n_val = sum(r["event"] == "val_eval" for r in records)
    leaves = dict(trees.leaves_with_names(tt.state.params))
    for name, x in leaves.items():
        for tag in (name, f"grad/{name}"):
            hs = acc.Histograms(tag)
            assert [h.step for h in hs] == list(range(n_val)), tag
            assert all(h.histogram_value.num == x.numel() for h in hs), tag


def test_tb_export_matches_the_jax_exporter(tmp_path):
    path = str(tmp_path / "metrics.jsonl")
    log = JMetricsLogger(path)
    log.log("train_epoch", epoch=0, loss=0.7)
    for epoch in range(3):
        log.log_eval("val", epoch, 0.7 - 0.01 * epoch, 0.5 + 0.02 * epoch,
                     {"0": 0.51 + epoch / 100, "1": 0.49})
    log.log_eval("test", 2, 0.66, 0.55, {"0": 0.56, "1": 0.54})
    jtb_export.export(path, str(tmp_path / "jax"))
    assert tb_export.export(path, str(tmp_path / "port")) == str(tmp_path / "port")
    ja, ta = _accumulator(str(tmp_path / "jax")), _accumulator(str(tmp_path / "port"))
    assert sorted(ta.Tags()["scalars"]) == sorted(ja.Tags()["scalars"])
    assert len(ta.Tags()["scalars"]) == 8
    for tag in ja.Tags()["scalars"]:
        assert ([(e.wall_time, e.step, e.value) for e in ta.Scalars(tag)]
                == [(e.wall_time, e.step, e.value) for e in ja.Scalars(tag)]), tag


@pytest.mark.parametrize("values", [
    [-1.0, 0.0, 0.0, 2.5],
    [3.0],
    [0.0, 0.0],
    [-3e21, -1e-13, 1e-13, 1e21, 1e-12, 7.5e3],
    "normal",
])
def test_histogram_matches_summary_writer(tmp_path, values):
    """The buckets counted on the tensor's device (here the CPU), the limits
    and the moments, against what SummaryWriter's ``add_histogram`` computes
    (``make_histogram`` over its ``default_bins``), values out of the bins'
    range and on a limit included."""
    from torch.utils.tensorboard import SummaryWriter
    from torch.utils.tensorboard.summary import make_histogram

    writer = SummaryWriter(log_dir=str(tmp_path))
    bins = writer.default_bins
    writer.close()

    if values == "normal":
        values = np.random.default_rng(0).normal(0, 0.05, 5000).astype(np.float32)
    x = torch.as_tensor(np.asarray(values, np.float32))
    got = histogram(x)
    want = make_histogram(x.numpy().astype(float), bins)
    assert got["bucket_limits"] == list(want.bucket_limit)
    assert got["bucket_counts"] == list(want.bucket)
    assert got["num"] == want.num
    np.testing.assert_allclose([got["min"], got["max"], got["sum"], got["sum_squares"]],
                               [want.min, want.max, want.sum, want.sum_squares], rtol=1e-12)


def test_a_run_without_tensorboard_imports_none_of_it(tmp_path):
    """The writer's import waits for the first write: a whole trainer with
    TensorBoard off (the default) leaves ``torch.utils.tensorboard`` out of
    ``sys.modules``."""
    code = (
        "import sys\n"
        "from mamdr_tpu_torch.config import ExperimentConfig\n"
        "from mamdr_tpu_torch.data.synthetic import make_synthetic_dataset\n"
        "from mamdr_tpu_torch.train.trainer import Trainer\n"
        "ds = make_synthetic_dataset(n_domain=2, n_uid=20, n_pid=20, n_per_domain=64,"
        " seed=1, batch_size=32)\n"
        "cfg = ExperimentConfig.from_dict({'model': {'name': 'mlp', 'user_dim': 8,"
        " 'item_dim': 8, 'domain_dim': 8, 'hidden_dim': [8]}, 'train': {'epoch': 1,"
        f" 'checkpoint_path': {str(tmp_path / 'ckpt')!r}, 'result_save_path':"
        f" {str(tmp_path / 'result')!r}}}, 'dataset': {{'name': 'synthetic',"
        " 'batch_size': 32}})\n"
        "t = Trainer(cfg, ds, device='cpu', verbose=False)\n"
        "t.summarize('val', {'0': 0.6, '1': 0.7}, {'0': 0.5, '1': 0.6})\n"
        "assert not t.tb.enabled\n"
        "assert 'torch.utils.tensorboard' not in sys.modules\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
