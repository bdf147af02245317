"""Rules of the port package: it stands alone, and it runs on the card.

- No module of ``mamdr_tpu_torch`` and not ``chip_smoke.py`` imports JAX,
  flax, optax or anything of the JAX package.
- Entry points run on CUDA unless the caller passes ``device="cpu"``: with
  no card and no device they raise instead of falling back to the CPU.
"""

import ast
import os

import pytest
import torch

import mamdr_tpu_torch
from mamdr_tpu_torch import resolve_device
from mamdr_tpu_torch.config import ExperimentConfig
from mamdr_tpu_torch.data.synthetic import make_synthetic_dataset
from mamdr_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mamdr_tpu")


def _port_sources():
    pkg = os.path.dirname(mamdr_tpu_torch.__file__)
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            yield from (a.value for a in node.args if isinstance(a, ast.Constant))


def test_port_imports_nothing_of_jax_or_the_jax_package():
    paths = list(_port_sources())
    assert len(paths) > 15 and os.path.exists(paths[-1])
    for path in paths:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in FORBIDDEN, f"{path} imports {mod}"


def test_entry_points_need_the_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the rule under test is the no-card case")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    cfg = ExperimentConfig.from_dict({
        "model": {"name": "mlp", "user_dim": 4, "item_dim": 4, "domain_dim": 4,
                  "hidden_dim": [8]},
        "dataset": {"name": "synthetic", "batch_size": 16},
    })
    ds = make_synthetic_dataset(n_domain=2, n_uid=10, n_pid=10, n_per_domain=64,
                                batch_size=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, ds)
    assert Trainer(cfg, ds, device="cpu").device == torch.device("cpu")
