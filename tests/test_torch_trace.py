"""The program's spans and counters (``mamdr_tpu_torch/utils/trace.py``) on
the CPU, at a tiny size:

- with tracing off ``span()`` is one shared null context and a MAMDR epoch
  makes no ``record_function`` call;
- under a CPU ``torch.profiler`` with spans on, the spans nest as the
  layers do (the train step's parts inside ``step``, inside the DN phase;
  the kernels' wrappers inside ``step.loss_grad``; the DR merges inside the
  DR phase), with the DR lanes all at once and in groups;
- an epoch's losses, ``shared`` and specific stack are bit-equal with spans
  on and off;
- the counters equal what the epoch's draws and the domains' step counts
  give, all-pad lane slots included on a ragged split;
- ``train.profile_dir``: a ``run()`` writes each epoch's trace with the
  strategy's and the trainer's spans in it, and an ``epoch_counters`` event,
  for the train loops, the ``*_separate`` runs and the finetune stage, by
  the lanes and by the per-domain loop;
- ``host_syncs`` counts every read of the card an epoch makes: its losses,
  its validation, one a tree its snapshots write.
"""

import contextlib
import json
import os

import numpy as np
import pytest
import torch

from mamdr_tpu_torch.config import ExperimentConfig
from mamdr_tpu_torch.data.synthetic import make_synthetic_dataset
from mamdr_tpu_torch.ops import fused_mlp_step
from mamdr_tpu_torch.strategies.base import build_strategy
from mamdr_tpu_torch.strategies.mamdr import MAMDRStrategy
from mamdr_tpu_torch.train import checkpoints
from mamdr_tpu_torch.train.trainer import Trainer
from mamdr_tpu_torch.utils import trace, trees

BATCH = 32
N_DOMAIN = 4


def _trainer(tmp_path, chunk=0, model="mlp_meta_mamdr_finetune", **train):
    """A tiny trainer on a ragged split (6, 4, 3, 2 steps a domain) with
    trainable tables and dropout on."""
    cfg = ExperimentConfig.from_dict({
        "model": {"name": model, "user_dim": 8, "item_dim": 8, "domain_dim": 8,
                  "hidden_dim": [16, 8], "dropout": 0.5},
        "train": {"emb_trainable": True, "learning_rate": 1e-2, "meta_learning_rate": 0.1,
                  "sample_num": 2, "dr_lane_chunk": chunk, "metrics_jsonl": False,
                  "checkpoint_path": str(tmp_path / "ckpt"),
                  "result_save_path": str(tmp_path / "result"), **train},
        "dataset": {"name": "synthetic", "batch_size": BATCH, "seed": 21}})
    ds = make_synthetic_dataset(n_domain=N_DOMAIN, n_uid=50, n_pid=60, n_per_domain=300,
                                seed=21, long_tail=True, batch_size=BATCH)
    return Trainer(cfg, ds, device="cpu", verbose=False)


def _strategy(tmp_path, chunk=0, model="mlp_meta_mamdr_finetune", **train):
    """A tiny MAMDR on the ragged split."""
    return MAMDRStrategy(_trainer(tmp_path, chunk, model, **train))


def _prepared(tmp_path, chunk=0):
    s = _strategy(tmp_path, chunk)
    s.prepare_fused()
    assert s.dr_lanes and s._dr_lane_chunk_effective == chunk
    return s


def _parents(events):
    """{(name, start): the names of the spans enclosing it, outermost first}
    of a profile's user annotations (one thread)."""
    spans = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                    for e in events if e.is_user_annotation()), key=lambda s: (s[0], -s[1]))
    out, stack = [], []
    for s in spans:
        while stack and stack[-1][1] <= s[0]:
            stack.pop()
        out.append((s[2], tuple(x[2] for x in stack)))
        stack.append(s)
    return out


def test_span_off_is_one_shared_null_context(tmp_path, monkeypatch):
    s = _prepared(tmp_path, chunk=2)
    assert trace.span("step") is trace.span("engine.merge")
    assert isinstance(trace.span("step"), contextlib.nullcontext)
    calls = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: calls.append(name) or contextlib.nullcontext())
    s.run_fused_epoch()
    assert calls == []
    with trace.enabled():
        s.run_fused_epoch()
    assert "step" in calls and "strategy.dr_phase" in calls
    assert trace.span("step") is trace.span("k1.tower")  # off again after the block


@pytest.mark.parametrize("chunk", [0, 2], ids=["all_lanes", "groups"])
def test_spans_nest_as_the_layers_do(tmp_path, chunk):
    s = _prepared(tmp_path, chunk)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.enabled():
            s.run_fused_epoch()
    nest = _parents(prof.profiler.kineto_results.events())
    names = {n for n, _ in nest}
    assert {"strategy.draw", "strategy.dn_phase", "strategy.dr_phase", "strategy.sync",
            "engine.shuffle", "engine.lane_state", "engine.merge", "engine.specific_update",
            "engine.write_back", "engine.reptile", "step", "step.seeds", "step.loss_grad",
            "step.adam", "step.apply", "step.gate", "k1.tower", "k2.gather"} <= names
    assert not any(n.startswith(("dn:", "dr:")) for n in names)
    for name, up in nest:
        if name in ("step.seeds", "step.loss_grad", "step.adam", "step.apply", "step.gate"):
            assert up[-1] == "step", (name, up)
        if name in ("k1.tower", "k2.gather"):
            assert up[-2:] == ("step", "step.loss_grad"), (name, up)
        if name == "step":
            assert up[0] in ("strategy.dn_phase", "strategy.dr_phase"), up
        if name.startswith("engine.") and name != "engine.shuffle":
            assert up and up[0] in ("strategy.dn_phase", "strategy.dr_phase"), (name, up)
    dn_steps = [up for n, up in nest if n == "step" and up[0] == "strategy.dn_phase"]
    assert len(dn_steps) == sum(s.trainer.steps_per_domain())
    assert ("step.adam", ("strategy.dn_phase", "step")) in nest
    assert any(n == "engine.merge" and up == ("strategy.dr_phase",) for n, up in nest)


def _epoch(tmp_path, spans: bool):
    s = _prepared(tmp_path, chunk=2)
    with trace.enabled(spans):
        losses = s.run_fused_epoch()
    return losses, s


def test_epoch_bit_equal_with_spans_on_and_off(tmp_path):
    off_losses, off = _epoch(tmp_path / "off", False)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        on_losses, on = _epoch(tmp_path / "on", True)
    np.testing.assert_array_equal(on_losses, off_losses)
    for a, b in zip(trees.leaves(on.shared), trees.leaves(off.shared)):
        assert torch.equal(a, b)
    for a, b in zip(trees.leaves(on._spec_stack), trees.leaves(off._spec_stack)):
        assert torch.equal(a, b)


def _expected(s):
    """The counters of the epoch whose draws are ``s.order`` / ``s.aux``."""
    t = s.trainer
    steps, rows = t.steps_per_domain(), [sp.n for sp in t.dataset.train]
    chunk = s._dr_lane_chunk_effective or N_DOMAIN
    order, aux = [int(q) for q in s.order], s.aux.tolist()
    out = {"steps.dn": sum(steps[d] for d in order), "examples.dn": sum(rows[d] for d in order),
           "examples.dr": sum(rows[a] + rows[q] for q, row in zip(order, aux) for a in row),
           "lane_steps.dr": 0, "lane_slots.dr": 0, "pad_lane_slots.dr": 0, "host_syncs": 1}
    for start in range(0, N_DOMAIN, chunk):
        lanes = range(start, min(start + chunk, N_DOMAIN))
        for j in range(len(aux[0])):
            for doms in ([aux[l][j] for l in lanes], [order[l] for l in lanes]):
                longest = max(steps[d] for d in doms)
                out["lane_steps.dr"] += longest
                out["lane_slots.dr"] += longest * len(doms)
                out["pad_lane_slots.dr"] += sum(longest - steps[d] for d in doms)
    return out


@pytest.mark.parametrize("chunk", [0, 2], ids=["all_lanes", "groups"])
def test_counters_follow_the_draws(tmp_path, chunk):
    s = _prepared(tmp_path, chunk)
    before = trace.counters()
    s.run_fused_epoch()
    got = trace.since(before)
    want = _expected(s)
    assert {k: got.get(k, 0) for k in want} == want
    assert want["pad_lane_slots.dr"] > 0  # the split is ragged
    assert set(got) == set(want)  # no kernel launch on the CPU
    for name in ("k1.launches", "k1_lanes.launches", "k2.launches", "k2.lane_launches",
                 "k2.window_launches", "k3.launches"):
        assert name in before
    # K1's CUDA count is read only once its library is loaded: never here
    assert fused_mlp_step.k1_cuda_launches(build=False) is None
    assert "k1.cuda_launches" not in before


def _counting_trees(monkeypatch):
    """The trees the snapshots write, counted as ``checkpoints`` reads them."""
    trees_read = []
    flatten = checkpoints._flatten
    monkeypatch.setattr(checkpoints, "_flatten",
                        lambda tree: trees_read.append(1) or flatten(tree))
    return trees_read


def _epoch_events(t):
    with open(os.path.join(t.checkpoint_dir, "metrics.jsonl")) as f:
        return [e for e in map(json.loads, f) if e["event"] == "epoch_counters"]


def test_profile_dir_writes_each_epochs_trace(tmp_path, monkeypatch):
    s = _strategy(tmp_path, model="mlp_meta_mamdr", epoch=1, metrics_jsonl=True,
                  profile_dir=str(tmp_path / "prof"))
    trees_read = _counting_trees(monkeypatch)
    s.run()
    with open(tmp_path / "prof" / "epoch_0.trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"trainer.epoch", "strategy.dn_phase", "strategy.dr_phase", "trainer.validate",
            "trainer.snapshot", "step.adam", "eval.auc"} <= names
    assert sorted(os.listdir(tmp_path / "prof")) == ["epoch_0.trace.json"]
    with open(os.path.join(s.trainer.checkpoint_dir, "metrics.jsonl")) as f:
        events = [json.loads(line) for line in f]
    (counted,) = [e for e in events if e["event"] == "epoch_counters"]
    assert (counted["trace"], counted["epoch"]) == ("epoch_0", 0)
    assert counted["counters"]["steps.dn"] == sum(s.trainer.steps_per_domain())
    # the epoch's losses, the validation's one read, a read a snapshot tree
    assert trees_read and counted["counters"]["host_syncs"] == 2 + len(trees_read)
    assert trace.span("step") is trace.span("step.adam")  # spans off after the run


@pytest.mark.parametrize("model, fused, separate", [
    ("mlp_separate", True, ["epoch_0"]),
    ("mlp_separate", False, [f"domain_{d}_epoch_0" for d in range(N_DOMAIN)]),
    ("mlp_meta_mamdr_finetune", True, ["finetune_epoch_0"]),
    ("mlp_meta_mamdr_finetune", False, [f"finetune_domain_{d}_epoch_0" for d in range(N_DOMAIN)]),
], ids=["separate_lanes", "separate_loop", "finetune_lanes", "finetune_loop"])
def test_profile_dir_traces_separate_and_finetune_epochs(tmp_path, model, fused, separate):
    """The ``*_separate`` runs and the finetune stage, by the lanes and by
    the per-domain loop, write a trace an epoch (of each domain, in the
    loop) holding the epoch's span (``trainer.finetune`` in the finetune
    stage) and the train steps; each logs one read, the validation's."""
    t = _trainer(tmp_path, model=model, epoch=1, metrics_jsonl=True, separate_fused=fused,
                 profile_dir=str(tmp_path / "prof"))
    build_strategy(t).run()
    traces = separate if model.endswith("_separate") else ["epoch_0"] + separate
    assert sorted(os.listdir(tmp_path / "prof")) == sorted(f"{n}.trace.json" for n in traces)
    events = {e["trace"]: e["counters"] for e in _epoch_events(t)}
    assert sorted(events) == sorted(traces)
    for name in separate:
        with open(tmp_path / "prof" / f"{name}.trace.json") as f:
            names = {e.get("name") for e in json.load(f)["traceEvents"]}
        span = "trainer.finetune" if name.startswith("finetune_") else "trainer.epoch"
        assert {span, "step", "step.loss_grad", "trainer.validate", "eval.auc"} <= names, name
        assert events[name]["host_syncs"] == 1, name


def test_host_syncs_of_a_joint_epoch(tmp_path, monkeypatch):
    """A joint epoch reads its losses, its validation and its best snapshot's
    tree."""
    t = _trainer(tmp_path, model="mlp", epoch=1, metrics_jsonl=True,
                 profile_dir=str(tmp_path / "prof"))
    trees_read = _counting_trees(monkeypatch)
    build_strategy(t).run()
    (counted,) = _epoch_events(t)
    assert trees_read == [1]
    assert counted["counters"]["host_syncs"] == 3


def test_an_epoch_left_by_break_writes_its_trace(tmp_path):
    """A loop that stops early (``break``) closes ``Trainer.epochs``: the
    epoch it left is traced and logged all the same."""
    s = _strategy(tmp_path, epoch=5, metrics_jsonl=True, profile_dir=str(tmp_path / "prof"))
    t = s.trainer
    for epoch in t.epochs():
        s.prepare_fused()
        s.run_fused_epoch()
        break
    assert os.listdir(tmp_path / "prof") == ["epoch_0.trace.json"]
    with open(os.path.join(t.checkpoint_dir, "metrics.jsonl")) as f:
        (line,) = f
    assert json.loads(line)["counters"]["host_syncs"] == 1
    assert trace.span("step") is trace.span("step.adam")


def test_no_profile_dir_no_trace(tmp_path):
    s = _strategy(tmp_path, model="mlp_meta_mamdr", epoch=1, metrics_jsonl=True)
    s.run()
    assert not any("trace.json" in f for _, _, fs in os.walk(tmp_path) for f in fs)
    with open(os.path.join(s.trainer.checkpoint_dir, "metrics.jsonl")) as f:
        assert all(json.loads(line)["event"] != "epoch_counters" for line in f)
