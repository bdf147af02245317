"""Whole runs of the harness at a tiny size on the CPU: the port (its plain
kernel versions) against the reference, the result line, the control, and
the faults that ``correct`` has to catch."""

from __future__ import annotations

import json

import pytest
import torch

from portbench import control, harness

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
    assert harness.judge(numbers, TIGHT), numbers

# What the parent of the split into a configuration's own files read of the
# a13 cell at the tiny size on SEED, on one thread: its inputs (sums of the
# train columns over the domains, and of each shared leaf and its square),
# every number of its comparison, and the work of the first epoch.
PINNED_INPUTS = {
    "train": [237440.0, 233964.0, 544.0],
    "shared0": {"user_emb": [0.0004268236632540834, 2.4037338257320083e-05],
                "item_emb": [0.0009312164321357841, 2.3804666406912147e-05],
                "domain_emb": [-0.00031423760162851977, 5.952491834041525e-07],
                "W0": [5.567743859952316, 19.510382037435704], "b0": [0.0, 0.0],
                "W1": [7.468369483947754, 9.108130954729859], "b1": [0.0, 0.0],
                "Wl": [0.6491087600588799, 1.67826312687248]}}
PINNED_NUMBERS = {
    "feed_gap": 0.0, "tower_rows_off": 0.0, "tower_loss_gap": 0.0,
    "adam_step_gap": 6.672003792116225e-06, "tower_grad_gap": 7.648457502303791e-08,
    "dr_step_gap": 2.1989157932372027e-05, "shared_gap": 6.715820142370602e-06,
    "specific_gap": 6.453190307979852e-06, "loss_gap": 1.7571936212114356e-07,
    "moment_gap": 1.8786010744478121e-06}
PINNED_WORK = {"examples": 14796, "phase_examples": {"dn": 1620, "dr": 13176}, "batches": 75,
               "least_s": {"k1": 1.19902567164179e-06, "k2": 7.219104477611944e-07}}
PINNED_LIMITS = {"feed_gap": 0.0, "tower_rows_off": 0.25, "adam_step_gap": 0.001,
                 "dr_step_gap": 0.0004, "shared_gap": 0.45, "specific_gap": 0.45}


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sum(x):
    return float(x.double().sum())


def test_a13_reads_what_it_read_before_the_split(tiny, one_thread, tmp_path):
    """The same inputs, the same numbers and limits, the same work as
    before the cell's weights, reference, comparison and work count moved
    into the configuration's own files."""
    cell = tiny(*CELLS[0])
    inp = harness.make_inputs(cell, SEED, CPU)
    train = inp.traffic.splits["train"]
    assert [sum(_sum(cols[k]) for cols in train) for k in range(3)] == PINNED_INPUTS["train"]
    assert {n: [_sum(x), _sum(x * x)] for n, x in inp.shared0.items()} == \
        PINNED_INPUTS["shared0"]
    assert not inp.frozen and all(_sum(x) == 0.0 for t in inp.specific0 for x in t.values())
    (kind, numbers, _), = control.readings(cell, SEED, CPU, False)
    assert numbers == PINNED_NUMBERS
    full = harness.find_cell(cell.name)
    assert harness.load_limits(harness.BENCH_DIR, cell.name, full.parts.check.NUMBERS) == \
        PINNED_LIMITS
    system = harness.build_system(cell, inp, CPU, str(tmp_path))
    count = cell.parts.work.Counter(cell.config, inp, system, CPU)
    states = system.draw_states()
    work = count(states, full=True)
    assert {k: getattr(work, k) for k in PINNED_WORK} == PINNED_WORK
    examples = count(states)
    assert (examples.examples, examples.phase_examples) == (14796, PINNED_WORK["phase_examples"])
    assert examples.flops == work.flops == 14796 * cell.parts.work.example_flops((24, 16, 8))


@pytest.mark.parametrize("dr", ["lanes", "sequential"])
@pytest.mark.parametrize("frozen_tables", [False, True], ids=["trainable", "frozen"])
def test_work_count_matches_the_programs_counters(tiny, monkeypatch, tmp_path, frozen_tables,
                                                  dr):
    """An epoch's batches and Adam lane-steps, replayed from its draws,
    against what the program counted running it: its DN steps and DR
    lane-steps, and its lane slots less the all-pad ones; and a window of
    such epochs, with DR in lanes or sequential (one lane a step)."""
    from mamdr_tpu_torch.strategies.mamdr import MAMDRStrategy
    from mamdr_tpu_torch.utils import trace

    if dr == "sequential":
        monkeypatch.setattr(MAMDRStrategy, "_dr_parallel_eligible", lambda self: False)
    cell = tiny(*CELLS[0], frozen_tables)
    inp = harness.make_inputs(cell, SEED, CPU)
    system = harness.build_system(cell, inp, CPU, str(tmp_path))
    assert (system.group() is None) == (dr == "sequential")
    count = cell.parts.work.Counter(cell.config, inp, system, CPU)
    work = count(system.draw_states(), full=True)
    before = trace.counters()
    system.epoch()
    got = trace.since(before)
    assert work.batches == got["steps.dn"] + got["lane_steps.dr"]
    assert work.lane_steps == got["steps.dn"] + got["lane_slots.dr"] - got.get("pad_lane_slots.dr", 0)
    assert work.phase_examples == {"dn": got["examples.dn"], "dr": got["examples.dr"]}
    rec = harness.Record()
    attempted, failed = harness.window(system, 0.01, count, CPU, rec)
    assert attempted >= 1 and failed == 0
    assert rec.work.phase_examples == {k: attempted * v for k, v in work.phase_examples.items()}

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
    assert list(res["check"]) == list(cell.parts.check.NUMBERS)
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
        assert not harness.judge(rows[kind], TIGHT), kind


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
