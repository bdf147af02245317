"""The benchmark's run: one cell, one seed, one result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix, each a
file found by its name (``configs/<config>.json``, ``traffic/<mix>.json``).
The mix names its generator (``traffic/<generator>.py``: ``generate(cfg,
mix, seed, device)``), the one generator of that kind of traffic. Each
metric is read by ``metrics/<name>.py`` (``read(record)``: a number, or None
where the run has nothing for it to read); each cell's limits of ``correct``
are ``limits/<cell>.json``.

What belongs to a model is its configuration's, in the modules that the
configuration's file names; a new model brings these files and a
``BENCHMARK.json`` entry, and no file here changes:

- ``system``: ``systems/<system>.py``, the program under test.
  ``System(cfg, inputs, device, workdir)`` builds it on the run's
  ``Inputs``; it offers ``describe()`` (a line for standard error),
  ``setup_epoch(e)`` (set-up epoch ``e``, recording what the comparison
  reads), ``readings()`` (those readings), ``epoch()`` (one epoch, its
  losses), ``phases()`` ([(name, run)]: the epoch's phases in order, each
  run ending synchronised and giving its losses or None),
  ``draw_states()`` (the generators' states before an epoch, for the work
  count), ``finite()`` and ``close()``.
- ``reference``: ``reference/<reference>.py``, the plain reference (plain
  PyTorch, nothing of the program). ``make_weights(cfg, traffic, seed,
  device)`` gives (frozen tables, shared start, each domain's specific
  start), the shared start holding every leaf the optimizer trains;
  ``problem(cfg, inputs)`` is what the reference is built from, and
  ``Reference(problem, **control)`` runs it: ``run(epochs)`` gives the
  readings of the set-up's epochs.
- ``check``: ``checks/<check>.py``, the comparison. ``NUMBERS``: the numbers
  ``correct`` is judged on, each with a limit in the cell's limits file;
  ``compare(prog, ref, reference)`` gives ({number: value}, leaves left
  out) from the program's and the reference's readings, and a number it
  gives beyond ``NUMBERS`` is read and printed, not compared;
  ``CONTROLS``: [(name, control)], each control a ``Reference(problem,
  **control)`` put in the program's place (``control.py``).
- ``work``: ``work/<work>.py``, the work count. ``Counter(cfg, inputs,
  system, device)`` called with an epoch's states gives its
  ``yardstick.Work``: its examples by phase and their operations, and with
  ``full`` also its batches, its Adam lane-steps and each kernel's least
  time, from a replay of the epoch's draws.

What every configuration does is here: the traffic and the seeds from
``--seed``; the set-up (the inputs, the program built on them, its first
two epochs, which warm up every shape and are kept for the comparison);
the window (whole epochs back to back until ``--seconds`` have passed, the
last one finished and counted; with ``--trace 1`` each phase of those
epochs timed on its own for a third of it, then one more epoch under the
profiler); the peak memory, read before the program is freed; the
reference's same epochs from the same inputs; the judge (every number of
``NUMBERS`` finite and within its limit, and no epoch failed); the check
that no JAX module was loaded; and the result line.
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
from types import ModuleType
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import devtrace, yardstick
from portbench.card import card_line

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
SETUP_EPOCHS = 2
PHASE_SHARE = 1 / 3
FORBIDDEN = ("jax", "jaxlib", "flax", "mamdr_tpu")
# a configuration's modules: its key, and the folder its name is found in
PARTS = (("system", "systems"), ("reference", "reference"), ("check", "checks"),
         ("work", "work"))


@dataclass
class Parts:
    """The modules a configuration names."""

    system: ModuleType
    reference: ModuleType
    check: ModuleType
    work: ModuleType


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    parts: Parts


@dataclass
class Record:
    """What a run measured; the metric readers read it."""

    setup_s: float = math.nan
    window_s: float = math.nan
    work: yardstick.Work = field(default_factory=yardstick.Work)
    phase_s: Dict[str, float] = field(default_factory=dict)  # by phase, host clock to a sync
    phase_work: yardstick.Work = field(default_factory=yardstick.Work)
    phase_window_s: float = math.nan
    traced: Optional[devtrace.TraceSummary] = None
    traced_work: yardstick.Work = field(default_factory=yardstick.Work)
    trainable: int = 0  # elements of the trainable leaves, a lane


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

    parts = Parts(**{key: importlib.import_module(f"portbench.{folder}.{config[key]}")
                     for key, folder in PARTS})
    return Cell(workload, int(w["chips"]), config, mix,
                [m for m in bench["end_to_end"] if mine(m)],
                [m for m in bench["per_layer"] if mine(m)], parts)


def reader(name: str):
    """The ``read(record)`` of metrics/<name>.py."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def seeds_of(seed: int, plan_seed: int) -> Dict[str, int]:
    """The inputs' seeds: the data, the weights, the shuffles and the
    dropout from ``--seed``; the host's draws of each epoch (such as the
    domain order, which can set how many steps an epoch takes) from the
    traffic's ``plan_seed``, so that every seed gets the same work."""
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
    gen = importlib.import_module(f"portbench.traffic.{cell.traffic['generator']}")
    seeds = seeds_of(seed, cell.traffic["plan_seed"])
    traffic = gen.generate(cell.config, cell.traffic, seeds["traffic"], device)
    frozen, shared0, specific0 = cell.parts.reference.make_weights(
        cell.config, traffic, seeds["weights"], device)
    return Inputs(traffic, frozen, shared0, specific0, seeds)


def build_system(cell: Cell, inp: Inputs, device, workdir: str):
    return cell.parts.system.System(cell.config, inp, device, workdir)


def reference(cell: Cell, inp: Inputs, **control):
    """The plain reference of the cell's configuration on the run's inputs
    (with ``control``, one of its controls)."""
    ref = cell.parts.reference
    return ref.Reference(ref.problem(cell.config, inp), **control)


def setup_epochs(system):
    """The program's first epochs; their readings, as the comparison reads them."""
    took = []
    for e in range(SETUP_EPOCHS):
        t0 = time.perf_counter()
        system.setup_epoch(e)
        took.append(time.perf_counter() - t0)
    print("portbench: set-up epochs s " + " ".join(f"{t:.3f}" for t in took), file=sys.stderr)
    return system.readings()


def load_limits(root: str, workload: str, names) -> Dict[str, float]:
    """The cell's limit of each of ``names``."""
    with open(os.path.join(root, "limits", f"{workload}.json")) as f:
        limits = json.load(f)
    missing = [n for n in names if n not in limits]
    if missing:
        raise ValueError(f"limits for {workload} lack {missing}")
    return {n: float(limits[n]) for n in names}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number that has a limit is finite and within it."""
    return all(math.isfinite(numbers.get(n, math.nan)) and numbers[n] <= limit
               for n, limit in limits.items())


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def window(system, seconds: float, count, device, rec: Record):
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


def phase_window(system, seconds: float, count, rec: Record):
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
        finite = True
        for name, run in system.phases():
            a = time.perf_counter()
            losses = run()
            rec.phase_s[name] = rec.phase_s.get(name, 0.0) + time.perf_counter() - a
            finite = finite and (losses is None or bool(np.all(np.isfinite(losses))))
        failed += int(not finite)
        if time.perf_counter() - t0 >= seconds:
            break
    rec.phase_window_s = time.perf_counter() - t0
    for s in states:
        rec.phase_work.add(count(s))
    return len(states), failed


def traced_epoch(system, count, device, rec: Record) -> None:
    """One epoch under the profiler, and its work replayed in full."""
    state = system.draw_states()

    def one():
        for name, run in system.phases():
            with devtrace.span(name):
                run()

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
        print(f"portbench: {cell.name} seed {seed}: {system.describe()}", file=sys.stderr)
        prog = setup_epochs(system)
        count = cell.parts.work.Counter(cell.config, inp, system, device)
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
        numbers, left_out = cell.parts.check.compare(prog, ref.run(SETUP_EPOCHS), ref)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    rec.trainable = sum(x.numel() for x in inp.shared0.values())
    if limits is None:
        limits = load_limits(BENCH_DIR, cell.name, cell.parts.check.NUMBERS)
    correct = judge(numbers, limits) and failed == 0
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
    result["check"] = {n: {"value": numbers.get(n, math.nan), "limit": lim}
                       for n, lim in limits.items()}
    print(f"portbench: leaves left out of the changes: {left_out}; failed epochs: {failed}; "
          + "; ".join(f"{n} {v!r} (not compared)" for n, v in numbers.items()
                      if n not in limits), file=sys.stderr)
    for n, c in result["check"].items():
        print(f"check {n} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
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
