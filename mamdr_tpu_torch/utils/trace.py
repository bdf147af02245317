"""Spans and counters inside the program, on the device trace's clock.

``span(name)`` marks a part of the program. With tracing off (the default)
it is one flag test that returns a shared null context: no
``record_function`` call, no allocation, no clock read. Inside
``enabled()`` it is ``torch.profiler.record_function(name)``, so a profiler
running around the block records the span in the same event list as the
card's kernels, copies and sets, on that list's clock (the wall clock in
nanoseconds); a kernel carries the correlation id of the call that launched
it, and that call lies inside the span, so a reader of the trace can put the
kernel's device time under the span. The tracer keeps no timestamps of its
own. A span's parent is the span that
encloses it on the same thread.

Span names are ``<layer>.<part>``: ``strategy.*`` (strategies/mamdr.py),
``engine.*`` (train/fused.py), ``step`` and ``step.*`` (train/steps.py, the
optimizers), ``k1.tower`` and ``k2.gather`` (ops/), ``ple.experts``,
``ple.gates`` and ``ple.towers`` (PLE's forward, models/mtl.py; under the
lane step's ``vmap`` too), ``trainer.*`` (train/trainer.py, the strategies'
epoch loops) and ``eval.auc``. No name starts with ``dn:`` or ``dr:``.

``count(name, n)`` is always on: an integer add in a module dict, made on
the host from what the host knows, never a read of the device.
``to_host(x)`` is the program's read of a value from the card, counted in
``host_syncs``. ``counters()`` returns the counts with those a module keeps
itself and hands over with ``register`` (the kernels' launch counters,
``fused_tower_grad.launches`` and the rest, and their build seconds).
Among the program's own: ``ple.expert_rows`` and ``ple.expert_rows_used``
(models/mtl.py: rows times the PLE experts a forward computes, and times
those its selected head depends on).

``profiled(profile_dir, name, log)`` is the operator's trace
(``train.profile_dir``, through ``Trainer.profiled``): the block under
``torch.profiler.profile`` with spans on, written to
``<profile_dir>/<name>.trace.json`` (Chrome trace format; Perfetto reads
it), and the block's counters handed to ``log``.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Dict, Iterator, List

import numpy as np
import torch

_on = False
_OFF = contextlib.nullcontext()
_counts: Dict[str, int] = {}
_readers: List[Callable[[], Dict[str, float]]] = []


def span(name: str):
    """A context manager marking ``name``: ``record_function(name)`` inside
    ``enabled()``, else the shared null context."""
    if not _on:
        return _OFF
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def enabled(on: bool = True) -> Iterator[None]:
    """Spans on (or off, ``on=False``) for the block; the setting before it
    comes back after."""
    global _on
    was, _on = _on, bool(on)
    try:
        yield
    finally:
        _on = was


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name``."""
    _counts[name] = _counts.get(name, 0) + int(n)


def to_host(x: torch.Tensor) -> np.ndarray:
    """``x`` on the host as a numpy array: the host waits for the card, and
    the read is counted in ``host_syncs``."""
    count("host_syncs")
    return x.detach().cpu().numpy()


def register(read: Callable[[], Dict[str, float]]) -> None:
    """Adds the counters a module keeps itself: ``counters()`` calls
    ``read()`` and takes what it returns under the names it gives."""
    _readers.append(read)


def counters() -> Dict[str, float]:
    """Every counter of the process: the program's counts and those of each
    registered module (the kernels': K1 ``k1.launches`` /
    ``k1_lanes.launches`` and, once its library is loaded,
    ``k1.cuda_launches``; K2 ``k2.launches`` / ``k2.lane_launches`` /
    ``k2.window_launches``; K3 ``k3.launches``; the seconds each CUDA
    library took to build, ``build_s.<name>``)."""
    out: Dict[str, float] = dict(_counts)
    for read in _readers:
        out.update(read())
    return out


def since(before: Dict[str, float]) -> Dict[str, float]:
    """The counters' growth since ``before`` (an earlier ``counters()``),
    the ones that did not move left out."""
    now = counters()
    return {k: v - before.get(k, 0) for k, v in now.items() if v != before.get(k, 0)}


@contextlib.contextmanager
def profiled(profile_dir: str, name: str,
             log: Callable[[Dict[str, float]], None]) -> Iterator[None]:
    """The block under ``torch.profiler.profile`` (the CPU, and CUDA where
    the card is, synchronised before the profiler stops) with spans on, its
    trace written to ``<profile_dir>/<name>.trace.json`` and its counters'
    growth handed to ``log``, also when the block is left by an exception
    (a generator closed at a ``break`` of its loop, as ``Trainer.epochs``
    is). An empty ``profile_dir`` does nothing."""
    if not profile_dir:
        yield
        return
    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    before = counters()
    prof = torch.profiler.profile(activities=acts)
    try:
        with prof, enabled():
            try:
                yield
            finally:
                if cuda:
                    torch.cuda.synchronize()
    finally:
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, f"{name}.trace.json"))
        log(since(before))
