"""``spantrace``: device time and idle gaps by the program's spans, on
hand-made event lists; and the harness's traced run, which keeps the
program's spans off."""

from __future__ import annotations

import contextlib

import pytest
import torch

from portbench import harness, spantrace
from portbench.spantrace import Activity, Launch, Span
from test_portbench_epoch import CELLS, RESULT_KEYS, SEED, TIGHT

CPU = torch.device("cpu")
MAIN = 1


def _summary(spans, acts, launches, window=(0, 1000)):
    return spantrace.summarise(Span(*window, MAIN, spantrace.WINDOW), spans, acts, launches)


def test_a_kernel_goes_to_the_span_open_at_its_launch():
    """Launched inside ``step.adam``, run on the card after the step ended:
    its time is ``step.adam``'s, not that of the span open when it ran."""
    spans = [Span(0, 400, MAIN, "strategy.dn_phase"), Span(10, 100, MAIN, "step"),
             Span(20, 60, MAIN, "step.adam"), Span(100, 300, MAIN, "step"),
             Span(110, 200, MAIN, "step.gate")]
    acts = [Activity(150, 250, "mul", 7), Activity(250, 270, "where", 8),
            Activity(500, 520, "copy", 9), Activity(600, 630, "fill", 10)]
    launches = [Launch(30, MAIN, 7), Launch(150, MAIN, 8), Launch(350, MAIN, 9)]
    s = _summary(spans, acts, launches)
    assert s.device_s[("strategy.dn_phase", "step", "step.adam")] == pytest.approx(100e-9)
    assert s.device_s[("strategy.dn_phase", "step", "step.gate")] == pytest.approx(20e-9)
    assert s.device_s[("strategy.dn_phase",)] == pytest.approx(20e-9)
    assert s.device_s[("(unlinked)",)] == pytest.approx(30e-9) and s.unlinked == 1
    assert s.busy_s == pytest.approx(170e-9)
    assert s.device_under(spantrace.UPDATE) == pytest.approx(120e-9)
    assert s.numbers()["update_pct.train"] == pytest.approx(100 * 120 / 170)  # no overlap
    assert s.covered()[0] == pytest.approx(140 / 170)


def test_a_gap_goes_to_the_span_open_when_it_began():
    spans = [Span(0, 900, MAIN, "strategy.dn_phase"), Span(100, 300, MAIN, "step"),
             Span(300, 800, MAIN, "engine.reptile"), Span(950, 990, 2, "step")]
    acts = [Activity(0, 150, "k", 1), Activity(250, 320, "k", 2), Activity(700, 900, "k", 3)]
    launches = [Launch(0, MAIN, 1), Launch(110, MAIN, 2), Launch(310, MAIN, 3)]
    s = _summary(spans, acts, launches)
    # 150-250 began in a step; 320-700 in engine.reptile; 900-1000 after the phase
    assert s.idle_s[("strategy.dn_phase", "step")] == pytest.approx(100e-9)
    assert s.idle_s[("strategy.dn_phase", "engine.reptile")] == pytest.approx(380e-9)
    assert s.idle_s[()] == pytest.approx(100e-9)  # another thread's span does not count
    assert s.idle_under(("step",)) == pytest.approx(100e-9)
    assert s.numbers()["step_idle_pct.train"] == pytest.approx(10.0)
    busy, idle = s.covered()
    assert busy == pytest.approx(1.0) and idle == pytest.approx(480 / 580)
    # an activity past the window's end is busy only up to it
    s = _summary(spans, acts + [Activity(950, 1200, "k", 4)], launches + [Launch(920, MAIN, 4)])
    assert s.busy_s == pytest.approx(470e-9)
    assert sum(s.idle_s.values()) == pytest.approx(530e-9)
    assert s.numbers()["idle_pct"] == pytest.approx(53.0)


def test_annotation_mirrors_are_no_device_work():
    """A span's mirror on the card's timeline is left out by ``from_kineto``;
    what stays is the kernel, busy for its own interval only."""

    class Event:
        def __init__(self, name, start, dur, device, annotation, corr=0, thread=MAIN):
            self.v = (name, start, dur, device, annotation, corr, thread)

        def name(self):
            return self.v[0]

        def start_ns(self):
            return self.v[1]

        def duration_ns(self):
            return self.v[2]

        def device_type(self):
            return self.v[3]

        def is_user_annotation(self):
            return self.v[4]

        def correlation_id(self):
            return self.v[5]

        def start_thread_id(self):
            return self.v[6]

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = [Event(spantrace.WINDOW, 0, 1000, cpu, True),
              Event("step", 10, 500, cpu, True), Event("step", 10, 900, cuda, True),
              Event("dn: phase", 0, 1000, cpu, True),
              Event("aten::mul", 15, 20, cpu, False, 4),
              Event("cudaLaunchKernel", 20, 5, cpu, False, 5),
              Event("mul", 100, 50, cuda, False, 5)]
    window, spans, acts, launches = spantrace.from_kineto(events)
    assert [s.name for s in spans] == ["step"] and window.end == 1000
    assert [a.name for a in acts] == ["mul"]
    assert [c.corr for c in launches] == [5]
    s = spantrace.summarise(window, spans, acts, launches)
    assert s.busy_s == pytest.approx(50e-9) and s.device_s == {("step",): pytest.approx(50e-9)}


def test_step_host_time_counts_dn_steps_only():
    spans = [Span(0, 500, MAIN, "strategy.dn_phase"), Span(10, 110, MAIN, "step"),
             Span(200, 400, MAIN, "step"), Span(500, 900, MAIN, "strategy.dr_phase"),
             Span(600, 900, MAIN, "step")]
    s = _summary(spans, [Activity(0, 10, "k", 1)], [Launch(0, MAIN, 1)])
    assert s.step_host_us() == pytest.approx(150e-3)


def test_the_traced_run_keeps_the_programs_spans_off(tiny, monkeypatch):
    """Through a whole traced run of the tiny cell (set-up, the phase-timed
    window, the traced epoch), the program opens no span: the seven
    per-layer metrics read the trace they read before the program had
    spans. The result line's keys stay those of the harness."""
    seen = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: seen.append(name) or contextlib.nullcontext())
    res = harness.run_cell(tiny(*CELLS[0]), SEED, 0.5, True, CPU, 0.0, limits=TIGHT)
    assert seen == [] and res["correct"]
    assert list(res) == RESULT_KEYS + ["check"]


def test_spans_epoch_on_the_cpu(tiny, tmp_path):
    """On the CPU the spans-on epoch records the program's spans but no
    device activity, so it summarises to None."""
    cell = tiny(*CELLS[0])
    inp = harness.make_inputs(cell, 5, CPU)
    system = harness.build_system(cell, inp, CPU, str(tmp_path))

    def epoch():
        system.dn_phase()
        system.dr_phase()

    assert spantrace.spans_epoch(epoch, CPU) is None
    from mamdr_tpu_torch.utils import trace

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.enabled(), torch.profiler.record_function(spantrace.WINDOW):
            epoch()
    window, spans, acts, _ = spantrace.from_kineto(prof.profiler.kineto_results.events())
    names = {s.name for s in spans}
    assert window is not None and not acts
    assert {"strategy.dn_phase", "strategy.dr_phase", "step", "step.adam", "k1.tower",
            "k2.gather", "engine.merge"} <= names
