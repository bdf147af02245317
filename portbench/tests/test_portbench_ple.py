"""The cell ``a13-ple-mamdr.epoch-balanced`` at a tiny size on the CPU: its
comparison passes on the program's first epochs and fails under planted
faults (steps that change nothing, a half batch, the DR lanes' Adam slots
in bfloat16, a shared expert dropped, a dense leaf's gradient doubled), DR's
lanes in the program's groups of 7 and 2, and an epoch's work count against
the program's counters."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from portbench import control, harness
from test_portbench_epoch import (SEED, _bf16_lane_slots, _half_batch, _patch_step,
                                  _unchanged)

CPU = torch.device("cpu")
CELL = "a13-ple-mamdr.epoch-balanced"
TINY = dict(dim=8, hidden_dim=[16, 8], tower=[8], batch_size=32, ids=200)
# the program against the reference at the tiny size
TIGHT = {"feed_gap": 0.0, "rows_off": 0.05, "step_gap": 1e-3, "grad_gap": 1e-4,
         "shared_gap": 1e-2, "specific_gap": 1e-2}


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread: the ops are tiny."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny_ple(monkeypatch):
    """tiny_ple(n_domain, rows) -> the cell at a size the CPU holds: the
    same files and code, the widths, ids and rows shrunk on both sides."""
    import mamdr_tpu_torch.benchmarks as benchmarks

    orig = benchmarks.benchmark_config

    def small(bench, model):
        e = orig(bench, model)
        e.model.user_dim = e.model.item_dim = e.model.domain_dim = TINY["dim"]
        e.model.hidden_dim = list(TINY["hidden_dim"])
        e.model.tower_hidden_dim = list(TINY["tower"])
        e.dataset.batch_size = TINY["batch_size"]
        return e

    monkeypatch.setattr(benchmarks, "benchmark_config", small)

    def make(n_domain: int, rows: int) -> harness.Cell:
        cell = harness.find_cell(CELL)
        d = TINY["dim"]
        config = dict(cell.config, n_domain=n_domain, n_uid=TINY["ids"], n_pid=TINY["ids"],
                      user_dim=d, item_dim=d, domain_dim=d, hidden_dim=TINY["hidden_dim"],
                      tower_hidden_dim=TINY["tower"], batch_size=TINY["batch_size"])
        return dataclasses.replace(cell, config=config,
                                   traffic=dict(cell.traffic, rows_per_domain=rows))

    return make


def _no_shared_expert(monkeypatch):
    """PLE with its last shared expert dropped (its kernel and bias zeroed)."""
    from mamdr_tpu_torch.models.mtl import PLE

    orig = PLE._level

    def level(self, first, held, copy, total, p, task_in, shared_in):
        k, b = p["shared_expert_kernel"], p["shared_expert_bias"]
        keep = (torch.arange(k.shape[0]) < k.shape[0] - 1).to(k.dtype)
        p = dict(p, shared_expert_kernel=k * keep[:, None, None],
                 shared_expert_bias=b * keep[:, None])
        return orig(self, first, held, copy, total, p, task_in, shared_in)

    monkeypatch.setattr(PLE, "_level", level)


def doubled_tower_bias_grad(monkeypatch):
    """The towers' first bias gets twice its gradient: the forward, dx and
    every other leaf are unchanged, and Adam's step does not scale with a
    gradient, so only the dense gradients' comparison sees it."""
    from mamdr_tpu_torch.models.mtl import TaskTowers

    def forward(self, x, seeds=None):  # TaskTowers.forward, the first bias's gradient doubled
        if x.dim() == 2:
            x = x.expand(self.n_task, *x.shape)
        for li in range(self.n_layers):
            w, b = getattr(self, f"tower_kernel_{li}"), getattr(self, f"tower_bias_{li}")
            if li == 0:
                b = 2.0 * b - b.detach()
            x = torch.relu(torch.einsum("tbi,tio->tbo", x, w) + b[:, None, :])
            x = self.dropout(x, None if seeds is None else seeds[li])
        return torch.einsum("tbi,tio->tbo", x, self.tower_logit)[..., 0]

    monkeypatch.setattr(TaskTowers, "forward", forward)


FAULTS = {"unchanged": lambda mp: _patch_step(mp, _unchanged),
          "half_batch": lambda mp: _patch_step(mp, _half_batch),
          "bf16_lane_slots": _bf16_lane_slots, "no_shared_expert": _no_shared_expert,
          "doubled_tower_bias_grad": doubled_tower_bias_grad}


@pytest.mark.parametrize("fault", [None, *FAULTS])
def test_the_cell_is_correct_and_a_fault_is_not(tiny_ple, monkeypatch, fault):
    cell = tiny_ple(4, 200)
    if fault is not None:
        FAULTS[fault](monkeypatch)
    (kind, numbers, _), = control.readings(cell, SEED, CPU, False)
    assert kind == "program"
    assert harness.judge(numbers, TIGHT) == (fault is None), numbers
    if fault == "unchanged":  # the change norms' upper reading
        assert numbers["shared_gap"] == numbers["specific_gap"] == 1.0, numbers
    if fault == "doubled_tower_bias_grad":  # seen by the gradients alone
        assert numbers["grad_gap"] == pytest.approx(1.0), numbers
        assert harness.judge(dict(numbers, grad_gap=0.0), TIGHT), numbers


def test_groups_of_lanes_and_the_work_count(tiny_ple, tmp_path):
    """Nine domains: DR's lanes in the program's groups of 7 and 2, held to
    the reference; an epoch's work count against the program's counters."""
    from mamdr_tpu_torch.utils import trace
    from portbench.yardstick import PEAK_TF32_FLOPS

    cell = tiny_ple(9, 100)
    (_, numbers, _), = control.readings(cell, SEED, CPU, False)
    assert harness.judge(numbers, TIGHT), numbers
    inp = harness.make_inputs(cell, SEED, CPU)
    system = harness.build_system(cell, inp, CPU, str(tmp_path))
    assert system.describe() == "dr_lanes True group 7"
    work_mod = cell.parts.work
    work = work_mod.Counter(cell.config, inp, system, CPU)(system.draw_states(), full=True)
    before = trace.counters()
    system.epoch()
    got = trace.since(before)
    assert work.batches == got["steps.dn"] + got["lane_steps.dr"]
    assert work.lane_steps == got["steps.dn"] + got["lane_slots.dr"] - got.get(
        "pad_lane_slots.dr", 0)
    assert work.phase_examples == {"dn": got["examples.dn"], "dr": got["examples.dr"]}
    assert work.flops == work.examples * work_mod.config_example_flops(cell.config)
    assert work.least_s["gemm"] == pytest.approx(3 * work.flops / PEAK_TF32_FLOPS)
    c = cell.config
    assert work_mod.config_example_flops(dict(
        c, user_dim=128, hidden_dim=[512, 256], tower_hidden_dim=[64])) == 8_492_160
