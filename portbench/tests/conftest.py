"""Fixtures of the benchmark's own tests (``python -m pytest portbench/tests``
from the root of the repository; the card tests are marked ``gpu``).

``tiny`` cuts a cell to a size the CPU holds: the same files, code and
checks, with the widths, ids and rows shrunk on both sides (the benchmark's
configuration and the program's corpus configuration). ``card`` skips a
test where no CUDA card is present."""

from __future__ import annotations

import dataclasses
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402

TINY = dict(hidden_dim=[16, 8], dim=8, batch_size=64, rows=300, ids=300)


@pytest.fixture
def tiny(monkeypatch):
    """tiny(workload, n_domain, frozen_tables=False) -> the cell at the tiny
    size; ``frozen_tables`` loads the traffic's pretrained user and item
    tables and freezes them, as a Taobao configuration states."""
    import mamdr_tpu_torch.benchmarks as benchmarks

    orig = benchmarks.benchmark_config
    frozen = {"tables": False}

    def small(bench, model):
        e = orig(bench, model)
        e.model.user_dim = e.model.item_dim = e.model.domain_dim = TINY["dim"]
        e.model.hidden_dim = list(TINY["hidden_dim"])
        e.dataset.batch_size = TINY["batch_size"]
        e.train.load_pretrain_emb = frozen["tables"]
        e.train.emb_trainable = not frozen["tables"]
        return e

    monkeypatch.setattr(benchmarks, "benchmark_config", small)

    def make(workload: str, n_domain: int, frozen_tables: bool = False) -> harness.Cell:
        cell = harness.find_cell(workload)
        d = TINY["dim"]
        frozen["tables"] = frozen_tables
        config = dict(cell.config, n_domain=n_domain, n_uid=TINY["ids"], n_pid=TINY["ids"],
                      user_dim=d, item_dim=d, domain_dim=d, hidden_dim=TINY["hidden_dim"],
                      batch_size=TINY["batch_size"], load_pretrain_emb=frozen_tables,
                      emb_trainable=not frozen_tables)
        traffic = dict(cell.traffic, rows_per_domain=TINY["rows"])
        return dataclasses.replace(cell, config=config, traffic=traffic)

    return make


@pytest.fixture
def card():
    """The CUDA device; skips the test without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch.device("cuda")
