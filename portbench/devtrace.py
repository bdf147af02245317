"""Device-trace arithmetic over a ``torch.profiler`` window.

The method of the port's ``kernel_profile.py`` (parts 2 and 3: device busy
time as the sum of the card's activity, the idle share, CUDA launches a
step, kernels by time), made exact over a window: busy is the union of the
intervals of every device activity (kernels, copies, sets), so that
overlapping activities are not counted twice; a launch is a kernel on the
device (copies and sets are not kernels); an idle gap is an interval of the
window with nothing on the device, named by the harness span that was open
on the host when it began (the system's phase, ``dn`` or ``dr`` of a MAMDR
epoch) and the kernel that ended it.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW = "bench: traced window"
PHASE = ": phase"


def span(phase: str):
    """A host span of one of the system's phases, which the trace names
    gaps by."""
    return record_function(phase + PHASE)


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    launches: int
    kernel_s: Dict[str, float] = field(default_factory=dict)   # device seconds by name
    gaps: Dict[str, float] = field(default_factory=dict)       # idle seconds by label

    def time_of(self, match: Callable[[str], bool]) -> float:
        return sum(s for n, s in self.kernel_s.items() if match(n))

    def top(self, table: Dict[str, float], n: int = 10) -> List[List]:
        return [[k, v] for k, v in sorted(table.items(), key=lambda kv: -kv[1])[:n]]


def _short(name: str, width: int = 60) -> str:
    return name if len(name) <= width else name[: width - 3] + "..."


def trace(fn: Callable[[], None], device) -> Optional[TraceSummary]:
    """Run ``fn`` under the profiler (it must end synchronised with the
    device) and summarise the window; None when the trace holds no device
    activity."""
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            fn()
    return summarise(prof.profiler.kineto_results.events())


def summarise(events) -> Optional[TraceSummary]:
    window: Optional[Tuple[int, int]] = None
    spans: List[Tuple[int, int, str]] = []
    dev: List[Tuple[int, int, str]] = []
    for e in events:
        name = e.name()
        start, dur = e.start_ns(), e.duration_ns()
        if name == WINDOW or name.endswith(PHASE):
            # the harness's spans, on the host (and mirrored on the device's
            # timeline, which is no device work)
            if e.device_type() != DeviceType.CUDA:
                if name == WINDOW:
                    window = (start, start + dur)
                else:
                    spans.append((start, start + dur, name))
        elif e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            dev.append((start, start + dur, name))
    if window is None or not dev:
        return None
    dev.sort()
    spans.sort()
    span_starts = [s for s, _, _ in spans]

    def open_span(t: int) -> str:
        i = bisect.bisect_right(span_starts, t) - 1
        while i >= 0:
            s, e, n = spans[i]
            if s <= t < e:
                return n.split(":")[0]
            i -= 1
        return "host"

    kernel_s: Dict[str, float] = {}
    gaps: Dict[str, float] = {}
    busy = 0
    launches = 0
    edge = window[0]
    for s, e, name in dev:
        kernel_s[name] = kernel_s.get(name, 0.0) + (e - s) * 1e-9
        if not name.startswith(("Memcpy", "Memset")):
            launches += 1
        if s > edge:
            label = f"{open_span(edge)}: before {_short(name)}"
            gaps[label] = gaps.get(label, 0.0) + (s - edge) * 1e-9
        lo = max(s, edge)
        if e > lo:
            busy += e - lo
        edge = max(edge, e)
    return TraceSummary(window_s=(window[1] - window[0]) * 1e-9, busy_s=busy * 1e-9,
                        launches=launches, kernel_s=kernel_s, gaps=gaps)
