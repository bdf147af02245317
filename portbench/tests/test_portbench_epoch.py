"""Whole runs of the harness at a tiny size on the CPU: the port (its plain
kernel versions) against the reference, the result line, the control, and
the faults that ``correct`` has to catch."""

from __future__ import annotations

import json

import pytest
import torch

from portbench import check, control, harness

CPU = torch.device("cpu")
# a13 at 9 domains keeps the port's groups of 7 (and a group of 2)
CELLS = [("a13-mlp-mamdr.epoch-balanced", 9)]
# the program against the reference at the tiny size
TIGHT = {"feed_gap": 0.0, "tower_rows_off": 0.05, "adam_step_gap": 1e-3,
         "dr_step_gap": 1e-4, "shared_gap": 1e-3, "specific_gap": 1e-3}
SEED = 2**31 + 977
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("frozen_tables", [False, True], ids=["trainable", "frozen"])
@pytest.mark.parametrize("workload,n_domain", CELLS)
def test_epochs_agree_with_the_reference(tiny, workload, n_domain, frozen_tables):
    cell = tiny(workload, n_domain, frozen_tables)
    (kind, numbers, _), = control.readings(cell, SEED, CPU, False)
    assert kind == "program"
    assert check.judge(numbers, TIGHT), numbers


@pytest.mark.parametrize("traced", [False, True])
def test_result_line(tiny, traced):
    cell = tiny(*CELLS[0])
    res = harness.run_cell(cell, SEED, 0.5, traced, CPU, 0.0, limits=TIGHT)
    assert list(res) == RESULT_KEYS + ["check"]  # no trace of a card on the CPU
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    names = {m["name"] for m in (cell.per_layer if traced else cell.end_to_end)}
    assert set(res["metrics"]) <= names
    if not traced:
        assert set(res["metrics"]) == {"train_ex_per_s", "setup_s"}
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert list(res["check"]) == list(check.NUMBERS)
    json.dumps(res)


@pytest.mark.parametrize("workload,n_domain", CELLS)
def test_control_fails_where_the_program_passes(tiny, workload, n_domain):
    """The reference in TF32 (its operands rounded on the CPU) put in the
    program's place reads far above the program on the tower's steps; with
    the DR lanes' Adam slots in bfloat16, far above it on the lane-step."""
    rows = {k: n for k, n, _ in control.readings(tiny(workload, n_domain), SEED, CPU, True)}
    assert rows["tf32"]["tower_rows_off"] > 0.5 > 0.05 > rows["program"]["tower_rows_off"], rows
    assert rows["tf32"]["tower_loss_gap"] > 30 * rows["program"]["tower_loss_gap"], rows
    assert rows["bf16_slots"]["dr_step_gap"] > 10 * TIGHT["dr_step_gap"], rows
    for kind in ("tf32", "bf16_slots", "half_batch"):
        assert not check.judge(rows[kind], TIGHT), kind


def _patch_step(monkeypatch, wrap):
    import mamdr_tpu_torch.train.steps as steps
    import mamdr_tpu_torch.train.trainer as trainer

    orig = steps.make_train_step

    def make(*a, **kw):
        return wrap(orig(*a, **kw))

    monkeypatch.setattr(steps, "make_train_step", make)
    monkeypatch.setattr(trainer, "make_train_step", make)


def _unchanged(step):
    def same(state, batch):
        return state, step(state, batch)[1]
    return same


def _half_batch(step):
    def half(state, batch):
        w = batch["weight"]
        keep = (torch.arange(w.shape[-1], device=w.device) < w.shape[-1] // 2).to(w.dtype)
        return step(state, dict(batch, weight=w * keep))
    return half


def _bf16_lane_slots(monkeypatch):
    """The program's Adam keeps the DR lanes' slots in bfloat16."""
    from mamdr_tpu_torch.train.flat_optimizer import FlatAdam

    orig = FlatAdam.update

    def update(self, grads, state):
        updates, new = orig(self, grads, state)
        if new.mu.dim() < 2:
            return updates, new
        return updates, new._replace(
            mu=new.mu.to(torch.bfloat16).to(new.mu.dtype),
            nu=new.nu.to(torch.bfloat16).to(new.nu.dtype))

    monkeypatch.setattr(FlatAdam, "update", update)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "bf16_lane_slots"])
@pytest.mark.parametrize("workload,n_domain", CELLS)
def test_a_fault_is_not_correct(tiny, monkeypatch, fault, workload, n_domain):
    cell = tiny(workload, n_domain)
    if fault == "bf16_lane_slots":
        _bf16_lane_slots(monkeypatch)
    else:
        _patch_step(monkeypatch, {"unchanged": _unchanged, "half_batch": _half_batch}[fault])
    res = harness.run_cell(cell, SEED, 0.2, False, CPU, 0.0, limits=TIGHT)
    assert res["correct"] is False


@pytest.mark.gpu
def test_control_on_the_card(card, tiny):
    """On the card the control is the reference with TF32 on: it reads far
    above the program (its kernels) at a size a test run holds."""
    cell = tiny(*CELLS[0])
    rows = {k: n for k, n, _ in control.readings(cell, SEED, card, True)}
    assert rows["tf32"]["tower_rows_off"] > 0.5 > 0.05 > rows["program"]["tower_rows_off"], rows
