"""Device time and idle gaps put down to the program's own spans.

The program marks its parts with spans (``mamdr_tpu_torch/utils/trace.py``:
``strategy.*``, ``engine.*``, ``step`` and ``step.*``, ``k1.tower``,
``k2.gather``), each a ``record_function`` when its spans are on, so a
profiler around the program records them in the same event list as the
card's activity, on that list's clock. ``summarise`` reads such a list:

- device time by span: every kernel, copy or set on the card is linked to
  the runtime call that launched it by the correlation id kineto gives both
  (``correlation_id()``; an activity's ``linked_correlation_id()`` names the
  operator instead), and its time goes to the stack of program spans open
  on the launching thread at that call, not at its start on the card;
- idle by span: each interval of the window with nothing on the card goes
  to the stack of program spans open on the window's thread when it began;
- the spans' mirrors on the card's timeline (user annotations) are not
  device work, as in ``devtrace``.

``spans_epoch`` runs one epoch under the profiler with the program's spans
on, for a harness to call after its own traced epoch (whose spans stay
off); it gives None where the program has no tracer (a checkout older than
it). ``report`` prints the tables on standard error.
"""

from __future__ import annotations

import importlib
import sys
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from portbench.devtrace import PHASE

WINDOW = "bench: spans window"
# the program's layers (utils/trace.py names a span <layer>.<part>)
PROGRAM = ("strategy.", "engine.", "step", "k1.", "k2.", "trainer.", "eval.")
LAUNCH = "cu"  # the CUDA API calls: cudaLaunchKernel, cuLaunchKernelEx, ...
UPDATE = ("step.adam", "step.apply", "step.gate")
Path = Tuple[str, ...]


def is_program(name: str) -> bool:
    return name.startswith(PROGRAM) and not name.endswith(PHASE)


@dataclass
class Span:
    start: int
    end: int
    thread: int
    name: str


@dataclass
class Activity:
    """A kernel, copy or set on the card, with its correlation id."""

    start: int
    end: int
    name: str
    corr: int


@dataclass
class Launch:
    """A CUDA API call on the host that launched an activity."""

    time: int
    thread: int
    corr: int


@dataclass
class SpanSummary:
    window_s: float
    busy_s: float
    device_s: Dict[Path, float] = field(default_factory=dict)  # by stack of spans
    idle_s: Dict[Path, float] = field(default_factory=dict)
    host_s: Dict[Path, List[float]] = field(default_factory=dict)  # span durations by stack
    unlinked: int = 0  # activities whose launch the trace does not hold

    def device_under(self, names: Iterable[str]) -> float:
        """Device seconds launched inside any span of ``names`` (or of a
        name ending in ``.`` as a prefix)."""
        return sum(s for p, s in self.device_s.items() if _under(p, names))

    def idle_under(self, names: Iterable[str]) -> float:
        return sum(s for p, s in self.idle_s.items() if _under(p, names))

    @property
    def device_total_s(self) -> float:
        """The activities' own times summed: the busy time, with the little
        that overlapping activities share counted once for each."""
        return sum(self.device_s.values())

    def covered(self) -> Tuple[float, float]:
        """Shares of the device time and of the idle time under some
        program span."""
        busy = sum(s for p, s in self.device_s.items() if any(map(is_program, p)))
        idle = sum(s for p, s in self.idle_s.items() if any(map(is_program, p)))
        total_idle = sum(self.idle_s.values())
        return busy / self.device_total_s, idle / total_idle if total_idle else 0.0

    def step_host_us(self, phase: str = "strategy.dn_phase") -> Optional[float]:
        """The mean host duration of the ``step`` spans inside ``phase``."""
        runs = [d for p, ds in self.host_s.items()
                if p and p[-1] == "step" and phase in p for d in ds]
        return 1e6 * sum(runs) / len(runs) if runs else None

    def by_innermost(self, table: Dict[Path, float]) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for p, s in table.items():
            k = p[-1] if p else "(no program span)"
            out[k] = out.get(k, 0.0) + s
        return out

    def numbers(self) -> Dict[str, float]:
        """The per-layer numbers this trace gives (in %, and µs); a share of
        device time is one of ``device_total_s``."""
        busy, idle = self.covered()
        total = self.device_total_s
        out = {
            "update_pct.train": 100.0 * self.device_under(UPDATE) / total,
            "engine_pct.train": 100.0 * self.device_under(("engine.",)) / total,
            "step_idle_pct.train": 100.0 * self.idle_under(("step",)) / self.window_s,
            "busy_covered_pct": 100.0 * busy,
            "idle_covered_pct": 100.0 * idle,
            "idle_pct": 100.0 * (1.0 - self.busy_s / self.window_s),  # = the idle table's sum
        }
        host = self.step_host_us()
        if host is not None:
            out["host_us_per_step.dn"] = host
        return out


def _under(path: Path, names: Iterable[str]) -> bool:
    names = tuple(names)
    return any(p == n or (n.endswith(".") and p.startswith(n)) for p in path for n in names)


def _stacks(spans: Sequence[Span], times: Sequence[int]) -> List[Path]:
    """For each time (of one thread), the names of the spans open at it,
    outermost first; ``spans`` nest (they come from context managers)."""
    spans = sorted(spans, key=lambda s: (s.start, -s.end))
    order = sorted(range(len(times)), key=lambda i: times[i])
    out: List[Path] = [()] * len(times)
    stack: List[Span] = []
    i = 0
    for q in order:
        t = times[q]
        while i < len(spans) and spans[i].start <= t:
            while stack and stack[-1].end <= spans[i].start:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1].end <= t:
            stack.pop()
        out[q] = tuple(s.name for s in stack)
    return out


def from_kineto(events) -> Tuple[Optional[Span], List[Span], List[Activity], List[Launch]]:
    """(the window span, the program's spans, the card's activities, the
    launches) of a kineto event list. A launch is known by its name
    (``cudaLaunchKernel``, ``cuLaunchKernelEx``, ``cudaMemcpyAsync``...):
    torch 2.11's events carry no activity type."""
    window, spans, acts, launches = None, [], [], []
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():  # a span's mirror is no device work
                acts.append(Activity(e.start_ns(), e.start_ns() + e.duration_ns(), name,
                                     e.correlation_id()))
            continue
        start, thread = e.start_ns(), e.start_thread_id()
        if name == WINDOW:
            window = Span(start, start + e.duration_ns(), thread, name)
        elif e.is_user_annotation():
            if is_program(name):
                spans.append(Span(start, start + e.duration_ns(), thread, name))
        elif name.startswith(LAUNCH):
            launches.append(Launch(start, thread, e.correlation_id()))
    return window, spans, acts, launches


def summarise(window: Optional[Span], spans: List[Span], acts: List[Activity],
              launches: List[Launch]) -> Optional[SpanSummary]:
    """Device time, idle time and host time of spans by stack of program
    spans; None without a window or without activity on the card."""
    if window is None or not acts:
        return None
    launch_of = {c.corr: c for c in launches}
    by_thread: Dict[int, List[Span]] = {}
    for s in spans:
        by_thread.setdefault(s.thread, []).append(s)

    at: Dict[int, List[Tuple[int, int]]] = {}  # thread -> [(launch time, activity index)]
    unlinked = 0
    for i, a in enumerate(acts):
        c = launch_of.get(a.corr)
        if c is None:
            unlinked += 1
        else:
            at.setdefault(c.thread, []).append((c.time, i))
    path_of: Dict[int, Path] = {}
    for thread, items in at.items():
        stacks = _stacks(by_thread.get(thread, []), [t for t, _ in items])
        for (_, i), p in zip(items, stacks):
            path_of[i] = p

    out = SpanSummary(window_s=(window.end - window.start) * 1e-9, busy_s=0.0,
                      unlinked=unlinked)
    # busy as the union of the activities' intervals; each one's own time
    # goes to its launch's stack; each gap to the stack open when it began
    order = sorted(range(len(acts)), key=lambda i: acts[i].start)
    edge, busy, gaps = window.start, 0, []
    for i in order:
        a = acts[i]
        p = path_of.get(i, ("(unlinked)",))
        out.device_s[p] = out.device_s.get(p, 0.0) + (a.end - a.start) * 1e-9
        start, end = min(a.start, window.end), min(a.end, window.end)  # busy inside the window
        if start > edge:
            gaps.append((edge, start))
        lo = max(start, edge)
        if end > lo:
            busy += end - lo
        edge = max(edge, end)
    if window.end > edge:
        gaps.append((edge, window.end))
    out.busy_s = busy * 1e-9
    for (g0, g1), p in zip(gaps, _stacks(by_thread.get(window.thread, []),
                                         [g0 for g0, _ in gaps])):
        out.idle_s[p] = out.idle_s.get(p, 0.0) + (g1 - g0) * 1e-9
    for ss in by_thread.values():
        stack: List[Span] = []
        for s in sorted(ss, key=lambda s: (s.start, -s.end)):
            while stack and stack[-1].end <= s.start:
                stack.pop()
            stack.append(s)
            p = tuple(x.name for x in stack)
            out.host_s.setdefault(p, []).append((s.end - s.start) * 1e-9)
    return out


def spans_epoch(run_epoch, device) -> Optional[SpanSummary]:
    """``run_epoch()`` (which must end synchronised with the card) under the
    profiler with the program's spans on; None where the program has no
    tracer."""
    try:
        trace = importlib.import_module("mamdr_tpu_torch.utils.trace")
    except ImportError:
        return None
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof, trace.enabled():
        with record_function(WINDOW):
            run_epoch()
    return summarise(*from_kineto(prof.profiler.kineto_results.events()))


def _table(title: str, table: Dict[str, float], total: float, n: int = 16) -> str:
    rows = sorted(table.items(), key=lambda kv: -kv[1])[:n]
    return title + "".join(f"\n  {k:<40} {v:10.6f} s {100 * v / total:7.3f}%"
                           for k, v in rows)


def report(s: SpanSummary, out=sys.stderr) -> None:
    """The top spans of each table, by innermost span and by stack."""
    print(f"portbench: spans window {s.window_s:.6f} s busy {s.busy_s:.6f} s; "
          f"activities not linked to a launch {s.unlinked}", file=out)
    print(_table("portbench: spans device time by innermost span",
                 s.by_innermost(s.device_s), s.busy_s), file=out)
    print(_table("portbench: spans device time by stack",
                 {"/".join(p) or "(no program span)": v for p, v in s.device_s.items()},
                 s.busy_s), file=out)
    idle = sum(s.idle_s.values()) or 1.0
    print(_table("portbench: spans idle by innermost span", s.by_innermost(s.idle_s), idle),
          file=out)
    print(_table("portbench: spans idle by stack",
                 {"/".join(p) or "(no program span)": v for p, v in s.idle_s.items()}, idle),
          file=out)
    host = {"/".join(p): sum(ds) for p, ds in s.host_s.items()}
    print(_table("portbench: spans host time by stack", host, s.window_s), file=out)
