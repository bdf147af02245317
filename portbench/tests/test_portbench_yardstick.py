"""The yardstick's counts, and the MLP configuration's work count, against
the hand counts of the port's kernels at the bench shapes (PERF.md's kernel
table)."""

from __future__ import annotations

import pytest

from portbench import yardstick
from portbench.work import mamdr_mlp as y
from portbench.traffic.latent_clicks import domain_sizes

DIMS = (384, 256, 128, 64)


def test_k1_operations_and_bytes():
    assert y.example_flops(DIMS) * 1024 == 856_031_232  # 0.856 GFLOP a batch
    assert y.k1_bytes([1024], DIMS) == pytest.approx(4.27e6, rel=2e-3)
    # one lane is bound by its operations: 1.73 us
    assert y.k1_least_s([1024], DIMS) == pytest.approx(856_031_232 / 495e12)
    # lanes without data need nothing
    assert y.k1_least_s([1024, 0, 0], DIMS) == y.k1_least_s([1024], DIMS)


def _unique(n_ids, n_rows=100_000):
    return n_rows * (1.0 - (1.0 - 1.0 / n_rows) ** n_ids)


def test_k2_bytes_at_the_bench_shapes():
    w = (128, 128, 128)
    dn = y.k2_bytes(1024, [_unique(1024), _unique(1024), 1], w, (False, False, True))
    assert dn == pytest.approx(2.63e6, rel=3e-3)
    dr = y.k2_bytes(30 * 1024, [_unique(30 * 1024), _unique(30 * 1024), 30], w,
                    (False, False, True))
    assert dr == pytest.approx(74.7e6, rel=3e-3)


def test_examples_as_the_bench_counts_them():
    order = list(range(30))
    aux = [[(q + i + 1) % 30 for i in range(5)] + [q] for q in order]
    ex = y.plan_examples(order, aux, [12000] * 30, 1024, 0)
    assert ex["dn"] + ex["dr"] == 4_680_000  # bench.py's epoch
    capped = y.plan_examples(order[:13], [a[:6] for a in aux[:13]], [12000] * 30, 1024, 1)
    assert capped["dr"] == 13 * 6 * (12000 + 1024)


def test_longtail_law():
    sizes = domain_sizes(13, 20000, 1.5)
    assert sum(sizes) == pytest.approx(260_000, abs=13)
    assert sizes[0] == 87114 and sizes[-1] == 671
    assert domain_sizes(30, 20000, 1.0) == [20000] * 30


def test_adam_bytes_at_the_bench_shapes():
    """K4's bound at the a13 cell's leaves (100k x 128 user and item tables,
    13 x 128 domain table, 384-256-128-64-1 tower): 215.2 us one lane,
    1506.1 us seven lanes (PERF.md's kernel table)."""
    elements = 2 * 100_000 * 128 + 13 * 128 + y.tower_params(DIMS)
    assert yardstick.adam_least_s(elements, 1) == pytest.approx(215.2e-6, rel=1e-3)
    assert yardstick.adam_least_s(elements, 7) == pytest.approx(1506.1e-6, rel=1e-3)
    assert yardstick.adam_least_s(elements, 0) == 0.0


def test_work_adds_by_phase_and_kernel():
    a = yardstick.Work(examples=3, flops=30, batches=1, lane_steps=2,
                       phase_examples={"dn": 3}, least_s={"k1": 1.0})
    a.add(yardstick.Work(examples=5, flops=50, batches=2, lane_steps=7,
                         phase_examples={"dn": 1, "dr": 4}, least_s={"k2": 2.0}))
    assert (a.examples, a.flops, a.batches, a.lane_steps) == (8, 80, 3, 9)
    assert a.phase_examples == {"dn": 4, "dr": 4} and a.least_s == {"k1": 1.0, "k2": 2.0}
