"""The benchmark's run: one cell, one seed, one result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix; each
is a file found by its name (``configs/<config>.json``,
``traffic/<mix>.json``), and they name the code that serves them: the
traffic's ``generator`` (``traffic/<generator>.py``), the configuration's
``system`` (``systems/<system>.py``, the program under test) and its plain
``reference`` (``reference/<reference>.py``). Each metric is read by
``metrics/<name>.py``; each cell's limits are ``limits/<cell>.json``.

A run: set-up (the traffic, the weights and the seeds from ``--seed``, the
program built on them, its first two epochs, which warm up every shape and
are kept for the comparison), then the window (whole epochs back to back
until ``--seconds`` have passed, the last one finished and counted; with
``--trace 1`` each phase of those epochs timed on its own, then one more
epoch under the profiler); then the peak memory is read, the program freed,
and the reference runs the same two epochs from the same inputs.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import check, devtrace, yardstick
from portbench.card import card_line
from portbench.reference.mamdr_mlp import Problem, Readings

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
SETUP_EPOCHS = 2
PHASE_SHARE = 1 / 3
FORBIDDEN = ("jax", "jaxlib", "flax", "mamdr_tpu")


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


@dataclass
class Record:
    """What a run measured; the metric readers read it."""

    setup_s: float = math.nan
    window_s: float = math.nan
    work: yardstick.Work = field(default_factory=yardstick.Work)
    dn_s: float = 0.0
    dr_s: float = 0.0
    phase_work: yardstick.Work = field(default_factory=yardstick.Work)
    phase_window_s: float = math.nan
    traced: Optional[devtrace.TraceSummary] = None
    traced_work: yardstick.Work = field(default_factory=yardstick.Work)
    dims: tuple = ()


def _load_json(*parts: str) -> Dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def find_cell(workload: str, bench: Optional[Dict] = None) -> Cell:
    """A cell of BENCHMARK.json with its files, found by name."""
    bench = bench if bench is not None else _load_json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; cells: {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _load_json(ROOT, conf["file"])
    mix = _load_json(BENCH_DIR, "traffic", f"{w['traffic']}.json")

    def mine(metric):
        return workload in metric.get("workloads", [workload])

    return Cell(workload, int(w["chips"]), config, mix,
                [m for m in bench["end_to_end"] if mine(m)],
                [m for m in bench["per_layer"] if mine(m)])


def reader(name: str):
    """The ``read(record)`` of metrics/<name>.py."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def seeds_of(seed: int, plan_seed: int) -> Dict[str, int]:
    """The inputs' seeds: the data, the weights, the shuffles and the
    dropout from ``--seed``; the host's draws of each epoch (the domain
    order and each query domain's support domains, which set how many
    lane-steps an epoch of ragged lanes takes) from the traffic's
    ``plan_seed``, so that every seed gets the same work."""
    s = np.random.SeedSequence(int(seed)).generate_state(4, dtype=np.uint32)
    return {"traffic": int(s[0]), "weights": int(s[1]), "np": int(plan_seed),
            "shuffle": int(s[2]), "dropout": int(s[3])}


@dataclass
class Inputs:
    traffic: object
    frozen: Dict[str, torch.Tensor]
    shared0: Dict[str, torch.Tensor]
    specific0: List[Dict[str, torch.Tensor]]
    seeds: Dict[str, int]


def make_inputs(cell: Cell, seed: int, device) -> Inputs:
    from portbench.weights import make_weights

    gen = importlib.import_module(f"portbench.traffic.{cell.traffic['generator']}")
    seeds = seeds_of(seed, cell.traffic["plan_seed"])
    traffic = gen.generate(cell.config, cell.traffic, seeds["traffic"], device)
    shared0, specific0 = make_weights(cell.config, seeds["weights"], device)
    frozen = {} if cell.config["emb_trainable"] else dict(traffic.tables)
    return Inputs(traffic, frozen, shared0, specific0, seeds)


def build_system(cell: Cell, inp: Inputs, device, workdir: str):
    mod = importlib.import_module(f"portbench.systems.{cell.config['system']}")
    return mod.System(cell.config, inp.traffic, inp.frozen, inp.shared0, inp.specific0,
                      inp.seeds, device, workdir)


def problem(cell: Cell, inp: Inputs) -> Problem:
    c = cell.config
    return Problem(
        train=inp.traffic.splits["train"], frozen=inp.frozen, shared0=inp.shared0,
        specific0=inp.specific0, hidden=tuple(c["hidden_dim"]), dropout=c["dropout"],
        lr=c["learning_rate"], meta_lr=c["meta_learning_rate"], sample_num=c["sample_num"],
        add_query=c["add_query_domain"], shuffle_sequence=c["shuffle_sequence"],
        reg_step=c["domain_regulation_step"], batch=c["batch_size"], l2=c["l2"],
        np_seed=inp.seeds["np"], shuffle_seed=inp.seeds["shuffle"],
        dropout_seed=inp.seeds["dropout"])


def reference(cell: Cell, inp: Inputs, precision: str = "float32",
              fault: Optional[str] = None, slots: str = "float32"):
    """The plain reference of the cell's configuration on the run's inputs."""
    mod = importlib.import_module(f"portbench.reference.{cell.config['reference']}")
    return mod.Reference(problem(cell, inp), precision, fault, slots)


def setup_epochs(system) -> Readings:
    """The program's first epochs, read as the comparison reads them."""
    out = Readings()
    took = []
    for e in range(SETUP_EPOCHS):
        t0 = time.perf_counter()
        if e == 0:
            losses, out.calls, out.lanes = system.recorded_epoch()
            out.moment = system.moment_norms()
        else:
            losses = system.epoch()
        out.losses.append([float(x) for x in losses])
        took.append(time.perf_counter() - t0)
    out.shared_change = system.shared_change()
    out.specific_change = system.specific_change()
    print("portbench: set-up epochs s " + " ".join(f"{t:.3f}" for t in took), file=sys.stderr)
    return out


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Counter:
    """Counts the work of epochs from the generators' states before each:
    the examples from the host draws alone, or (``full``) every K1 and K2
    call's least time from a replay of all the draws."""

    def __init__(self, cell: Cell, inp: Inputs, system, device):
        c = cell.config
        self.work = yardstick.EpochWork(c, inp.traffic.splits["train"], c["batch_size"], device)
        self.plan = (c["domain_regulation_step"], c["sample_num"], c["add_query_domain"],
                     c["shuffle_sequence"])
        self.group = system.group()

    def __call__(self, states, full: bool = False) -> yardstick.Work:
        if full:
            return self.work.replay(*states, self.group, *self.plan)
        return self.work.examples(states[0], *self.plan)


def window(system, seconds: float, count: Counter, device, rec: Record):
    """Whole epochs back to back for ``seconds``, the last one finished and
    counted; returns (epochs attempted, epochs that raised or gave
    non-finite losses). An epoch that raises ends the window."""
    states, ends = [], []
    failed = 0
    gc.collect()
    gc.freeze()  # no collection walks the set-up's objects inside the window
    t0 = time.perf_counter()
    while True:
        states.append(system.draw_states())
        try:
            losses = system.epoch()
        except Exception:  # the run goes on to report it: not correct
            traceback.print_exc()
            failed += 1
            break
        failed += int(not np.all(np.isfinite(losses)))
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            break
    _sync(device)
    rec.window_s = time.perf_counter() - t0
    gc.unfreeze()
    print("portbench: epochs end at s " + " ".join(f"{e:.3f}" for e in ends), file=sys.stderr)
    for s in states[:len(states) - failed]:
        rec.work.add(count(s))
    return len(states), failed


def phase_window(system, seconds: float, count: Counter, rec: Record):
    """The window of a traced run: the same epochs, each phase timed on its
    own to a sync, for a third of ``seconds`` (the rest of a traced run's
    time goes to the profiled epoch and its trace); returns (epochs
    attempted, epochs with non-finite losses)."""
    seconds = seconds * PHASE_SHARE
    states = []
    failed = 0
    t0 = time.perf_counter()
    while True:
        states.append(system.draw_states())
        a = time.perf_counter()
        losses = system.dn_phase()
        b = time.perf_counter()
        system.dr_phase()
        rec.dn_s += b - a
        rec.dr_s += time.perf_counter() - b
        failed += int(not np.all(np.isfinite(losses)))
        if time.perf_counter() - t0 >= seconds:
            break
    rec.phase_window_s = time.perf_counter() - t0
    for s in states:
        rec.phase_work.add(count(s))
    return len(states), failed


def traced_epoch(system, count: Counter, device, rec: Record) -> None:
    """One epoch under the profiler, and its work replayed in full."""
    state = system.draw_states()

    def one():
        with devtrace.span("dn: phase"):
            system.dn_phase()
        with devtrace.span("dr: phase"):
            system.dr_phase()

    rec.traced = devtrace.trace(one, device)
    rec.traced_work = count(state, full=True)


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device,
             t_start: float, limits: Optional[Dict[str, float]] = None) -> Dict:
    """Set-up, window, trace, reference and comparison; returns the result
    (and prints the numbers compared on standard error)."""
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats(device)
    rec = Record()
    workdir = tempfile.mkdtemp(prefix="portbench-")
    marks = [("start", time.perf_counter())]

    def mark(name):
        _sync(device)
        marks.append((name, time.perf_counter()))

    try:
        inp = make_inputs(cell, seed, device)
        mark("inputs")
        system = build_system(cell, inp, device, workdir)
        mark("program")
        print(f"portbench: {cell.name} seed {seed}: {system.lanes}", file=sys.stderr)
        prog = setup_epochs(system)
        count = Counter(cell, inp, system, device)
        mark("epochs")
        rec.setup_s = time.perf_counter() - t_start
        print("portbench: set-up s: imports %.3f " % (marks[0][1] - t_start)
              + " ".join(f"{b[0]} {b[1] - a[1]:.3f}" for a, b in zip(marks, marks[1:])),
              file=sys.stderr)
        if traced:
            attempted, failed = phase_window(system, seconds, count, rec)
            traced_epoch(system, count, device, rec)
            attempted += 1
        else:
            attempted, failed = window(system, seconds, count, device, rec)
        _forbid()
        failed += int(not system.finite())
        peak = torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0
        system.close()
        del system
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        ref = reference(cell, inp)
        numbers, left_out = check.compare(prog, ref.run(SETUP_EPOCHS), ref)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    rec.dims = (3 * cell.config["user_dim"], *cell.config["hidden_dim"])
    limits = limits if limits is not None else check.load_limits(BENCH_DIR, cell.name)
    correct = check.judge(numbers, limits) and failed == 0
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu", "kind": _kind(device), "count": cell.chips,
                   "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if traced and rec.traced is not None:
        device_info["busy_s"] = rec.traced.busy_s
        device_info["window_s"] = rec.traced.window_s
        result["breakdown"] = {"device_ops": rec.traced.top(rec.traced.kernel_s),
                               "idle_gaps": rec.traced.top(rec.traced.gaps)}
    result["check"] = {n: {"value": numbers[n], "limit": limits[n]} for n in check.NUMBERS}
    print(f"portbench: leaves left out of the changes: {left_out}; failed epochs: {failed}; "
          + "; ".join(f"{n} {numbers[n]!r} (not compared)" for n in check.READ),
          file=sys.stderr)
    for n in check.NUMBERS:
        print(f"check {n} {numbers[n]!r} limit {limits[n]!r}", file=sys.stderr)
    return result


def _kind(device) -> str:
    if torch.device(device).type == "cuda":
        return torch.cuda.get_device_name(torch.device(device))
    return "cpu"


def _forbid() -> None:
    """Exit when a forbidden package was loaded in this process."""
    found = sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))
    if found:
        print(f"portbench: forbidden modules loaded: {found}", file=sys.stderr)
        raise SystemExit(3)


def main(argv: List[str], t_start: float) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = find_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s), found {n}",
              file=sys.stderr)
        return 2
    print(f"portbench: card {card_line()}", file=sys.stderr)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda"),
                      t_start)
    _forbid()
    print(json.dumps(result))
    return 0
