"""The benchmark's files: every cell found from its files by name, the
contract's shape of BENCHMARK.json, and what the harness may import."""

from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys

import pytest

from portbench import harness

BENCH = harness.BENCH_DIR
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "mamdr_tpu"}


def _bench():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("workload", [w["name"] for w in _bench()["workloads"]])
def test_cell_found_by_name(workload):
    cell = harness.find_cell(workload)
    c = cell.config
    for folder, name in [(folder, c[key]) for key, folder in harness.PARTS] + [
            ("traffic", cell.traffic["generator"])]:
        assert os.path.exists(os.path.join(BENCH, folder, f"{name}.py")), (folder, name)
    assert os.path.exists(os.path.join(BENCH, "limits", f"{workload}.json"))
    assert cell.end_to_end and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.reader(m["name"]))


def test_benchmark_contract_shape():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and 1 <= b["run_seconds"] <= 51
    configs = {c["name"]: c for c in b["configs"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    cells = set()
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in configs and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in cells
        cells.add((w["config"], w["traffic"]))
        assert len(w["why"]) <= 200
    for c in configs.values():
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        with open(os.path.join(harness.ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    names = set(e2e)
    for m in b["per_layer"]:
        assert m["moves"] in e2e and m["name"] not in names
        names.add(m["name"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m) <= {"name", "unit", "better", "bound", "source", "layer", "moves",
                          "workloads"}


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def _sources():
    for dirpath, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_jax_imported_by_the_benchmark():
    for path in _sources():
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_reference_imports_nothing_of_the_port():
    ref = os.path.join(BENCH, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            tops = {m.split(".")[0] for m in _imports(os.path.join(ref, f))}
            assert "mamdr_tpu_torch" not in tops and not tops & FORBIDDEN, (f, tops)
            assert not {m for m in _imports(os.path.join(ref, f))
                        if m.startswith("portbench.") and not m.startswith("portbench.reference")}


def test_run_loads_no_jax():
    """What a run imports (the harness, the system under test, the readers)
    loads no module named jax, jaxlib, flax or mamdr_tpu."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench import harness, control\n"
        "import portbench.systems.mamdr_epoch, portbench.traffic.latent_clicks\n"
        "import portbench.checks.mamdr_mlp, portbench.work.mamdr_mlp\n"
        "import mamdr_tpu_torch.strategies.mamdr, mamdr_tpu_torch.train.trainer\n"
        "import mamdr_tpu_torch.benchmarks, mamdr_tpu_torch.data.dataset\n"
        "for w in ('a13-mlp-mamdr.epoch-balanced',):\n"
        "    c = harness.find_cell(w)\n"
        "    [harness.reader(m['name']) for m in c.end_to_end + c.per_layer]\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n" % harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, timeout=300)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1].replace("'", '"')))
    assert not loaded & FORBIDDEN


def test_no_result_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(harness.torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "a13-mlp-mamdr.epoch-balanced", "--seed", "1",
                       "--seconds", "1", "--trace", "0"], 0.0)
    assert rc != 0 and capsys.readouterr().out == ""
