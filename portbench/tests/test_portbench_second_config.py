"""A second model through the harness with no edit to a shared file.

This module is a whole configuration of its own: a toy STAR-like model
over the same three fields (the user, item and domain rows concatenated, one
hidden layer whose kernel is a shared kernel times the domain's own, as
StarFCN merges them, and a logit kernel merged alike), trained by plain SGD
in MAMDR's two phases with DR run sequentially, one domain after another:

- DN: from ``shared``, every domain in turn, each in batches in an order
  drawn from the shuffle generator; ``shared`` becomes the result;
- DR: each domain d in turn from ``shared + specific[d]``, one pass over
  its batches; ``specific[d]`` becomes the result less ``shared``.

The program under test (``System``) takes gradients by autograd; the
reference (``Reference``) writes the backward pass out by hand. Both, the
weights, the comparison and the work count are this module's, which the
test hands to the harness under the names a configuration's file gives
(``toy_star``); the cell is found by name from a ``BENCHMARK.json`` of its
own and runs through ``harness.run_cell``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import sys
from typing import Dict

import pytest
import torch

from portbench import control, harness, yardstick
from test_portbench_epoch import SEED

CPU = torch.device("cpu")
NAME = "toy_star"
CELL = "toy-star.epoch-balanced"
CONFIG = {"name": "toy-star", "system": NAME, "reference": NAME, "check": NAME, "work": NAME,
          "n_domain": 4, "n_uid": 200, "n_pid": 200, "user_dim": 4, "hidden": 6,
          "batch_size": 32, "learning_rate": 0.5, "load_pretrain_emb": False}
LIMITS = {"param_gap": 1e-4}

# ---- the weights and the reference ----


def make_weights(cfg: Dict, traffic, seed: int, device):
    """Tables N(0, 0.1), shared kernels N(0, 1 / fan_in), the domains'
    kernels 1, bias 0; every leaf trains, and each specific start is 0."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    d, h, n = cfg["user_dim"], cfg["hidden"], cfg["n_domain"]

    def normal(scale, *shape):
        return torch.randn(shape, generator=g, device=device) * scale

    shared = {"user_emb": normal(0.1, cfg["n_uid"], d), "item_emb": normal(0.1, cfg["n_pid"], d),
              "domain_emb": normal(0.1, n, d), "W0": normal((3 * d) ** -0.5, 3 * d, h),
              "S0": torch.ones(n, 3 * d, h, device=device), "b0": torch.zeros(h, device=device),
              "W1": normal(h ** -0.5, h, 1), "S1": torch.ones(n, h, 1, device=device)}
    specific = [{k: torch.zeros_like(v) for k, v in shared.items()} for _ in range(n)]
    return {}, shared, specific


def problem(cfg: Dict, inputs) -> Dict:
    return {"cfg": cfg, "train": inputs.traffic.splits["train"], "shared0": inputs.shared0,
            "specific0": inputs.specific0, "shuffle": inputs.seeds["shuffle"]}


def batches(train, domains, gen: torch.Generator, batch: int):
    """The batches of ``domains`` in turn, the rows of each domain in the
    order of a permutation drawn for it."""
    for d in domains:
        uid, pid, label = train[d]
        perm = torch.randperm(uid.shape[0], generator=gen, device=uid.device)
        for s in range(0, uid.shape[0], batch):
            at = perm[s:s + batch]
            yield d, uid[at].long(), pid[at].long(), label[at]


class Reference:
    def __init__(self, prob: Dict, fault: str = None):
        self.prob, self.fault = prob, fault

    def _grads(self, p, d, uid, pid, y):
        """The loss and every leaf's gradient, written out."""
        dim = p["user_emb"].shape[1]
        x = torch.cat([p["user_emb"][uid], p["item_emb"][pid],
                       p["domain_emb"][d].expand(uid.shape[0], -1)], dim=1)
        w = torch.ones_like(y)
        if self.fault == "half_batch":
            w[y.shape[0] // 2:] = 0.0
        k0, k1 = p["W0"] * p["S0"][d], p["W1"] * p["S1"][d]
        z = x @ k0 + p["b0"]
        hid = torch.relu(z)
        logit = (hid @ k1)[:, 0]
        loss = torch.sum(w * (torch.nn.functional.softplus(logit) - y * logit)) / w.sum()
        dlogit = ((torch.sigmoid(logit) - y) * w / w.sum())[:, None]
        dk1 = hid.T @ dlogit
        dz = (dlogit @ k1.T) * (z > 0)
        dk0 = x.T @ dz
        dx = dz @ k0.T
        g = {k: torch.zeros_like(v) for k, v in p.items()}
        g["W0"], g["S0"][d] = dk0 * p["S0"][d], dk0 * p["W0"]
        g["W1"], g["S1"][d] = dk1 * p["S1"][d], dk1 * p["W1"]
        g["b0"] = dz.sum(0)
        g["user_emb"].index_add_(0, uid, dx[:, :dim])
        g["item_emb"].index_add_(0, pid, dx[:, dim:2 * dim])
        g["domain_emb"][d] = dx[:, 2 * dim:].sum(0)
        return loss, g

    def run(self, epochs: int) -> Dict:
        prob, cfg = self.prob, self.prob["cfg"]
        train, lr = prob["train"], cfg["learning_rate"]
        gen = torch.Generator(device=train[0][0].device).manual_seed(prob["shuffle"])
        shared = dict(prob["shared0"])
        specific = [dict(s) for s in prob["specific0"]]

        def phase(p, domains):
            losses = []
            for d, uid, pid, y in batches(train, domains, gen, cfg["batch_size"]):
                loss, g = self._grads(p, d, uid, pid, y)
                p = {k: p[k] - lr * g[k] for k in p}
                losses.append(float(loss))
            return p, losses

        out = {"losses": []}
        for _ in range(epochs):
            shared, losses = phase(shared, range(len(train)))
            out["losses"].append(losses)
            for d in range(len(train)):
                theta, _ = phase({k: shared[k] + specific[d][k] for k in shared}, [d])
                specific[d] = {k: theta[k] - shared[k] for k in shared}
        out["params"] = _tree(shared, specific)
        return out


def _tree(shared, specific) -> Dict[str, torch.Tensor]:
    tree = {f"shared/{k}": v for k, v in shared.items()}
    for d, s in enumerate(specific):
        tree.update({f"{d}/{k}": v for k, v in s.items()})
    return tree


# ---- the program under test ----


class System:
    """The toy program: autograd steps, DR sequential, one domain at a time."""

    fault = None

    def __init__(self, cfg: Dict, inputs, device, workdir: str):
        self.cfg, self.train = cfg, inputs.traffic.splits["train"]
        self.shared = {k: v.clone() for k, v in inputs.shared0.items()}
        self.specific = [{k: v.clone() for k, v in s.items()} for s in inputs.specific0]
        self.gen = torch.Generator(device=device).manual_seed(inputs.seeds["shuffle"])
        self.read = {"losses": []}
        self.dn_losses = None

    def describe(self) -> str:
        return "DR sequential"

    def _loss(self, p, d, uid, pid, y):
        x = torch.cat([p["user_emb"][uid], p["item_emb"][pid],
                       p["domain_emb"][d].expand(uid.shape[0], -1)], dim=1)
        hid = torch.relu(x @ (p["W0"] * p["S0"][d]) + p["b0"])
        logit = (hid @ (p["W1"] * p["S1"][d]))[:, 0]
        if self.fault == "half_batch":
            logit, y = logit[: y.shape[0] // 2], y[: y.shape[0] // 2]
        return torch.nn.functional.binary_cross_entropy_with_logits(logit, y)

    def _phase(self, p, domains):
        losses = []
        for d, uid, pid, y in batches(self.train, domains, self.gen, self.cfg["batch_size"]):
            leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
            loss = self._loss(leaves, d, uid, pid, y)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            with torch.no_grad():
                p = {k: v - self.cfg["learning_rate"] * g for (k, v), g in zip(leaves.items(), grads)}
            losses.append(float(loss.detach()))
        return p, losses

    def dn_phase(self):
        self.shared, self.dn_losses = self._phase(self.shared, range(len(self.train)))
        return self.dn_losses

    def dr_phase(self):
        for d in range(len(self.specific)):
            theta, _ = self._phase({k: self.shared[k] + self.specific[d][k]
                                    for k in self.shared}, [d])
            self.specific[d] = {k: theta[k] - self.shared[k] for k in self.shared}

    def phases(self):
        return [("dn", self.dn_phase), ("dr", self.dr_phase)]

    def epoch(self):
        self.dn_phase()
        self.dr_phase()
        return self.dn_losses

    def setup_epoch(self, e: int) -> None:
        self.read["losses"].append(self.epoch())

    def readings(self) -> Dict:
        self.read["params"] = _tree(self.shared, self.specific)
        return self.read

    def draw_states(self):
        return self.gen.get_state()

    def finite(self) -> bool:
        return all(bool(torch.isfinite(v).all()) for v in self.shared.values())

    def close(self) -> None:
        self.shared = self.specific = None


# ---- the comparison and the work count ----

NUMBERS = ("param_gap",)
CONTROLS = (("half_batch", {"fault": "half_batch"}),)


def compare(prog: Dict, ref: Dict, reference: Reference):
    """``param_gap``: each leaf's gap from the reference over how far the
    reference moved it from its start, the largest; ``loss_gap`` (read):
    the largest relative gap of the DN losses."""
    start = _tree(reference.prob["shared0"], reference.prob["specific0"])
    gaps = []
    for k, r in ref["params"].items():
        moved = float(torch.linalg.vector_norm((r - start[k]).double()))
        gaps.append(float(torch.linalg.vector_norm((prog["params"][k] - r).double()))
                    / max(moved, 1e-12))
    losses = [abs(p - r) / abs(r) for pe, re in zip(prog["losses"], ref["losses"])
              for p, r in zip(pe, re)]
    return {"param_gap": max(gaps), "loss_gap": max(losses)}, 0


class Counter:
    """Every real row trained, in DN and again in DR; a step a batch, and
    no Adam step and no kernel of the port's."""

    def __init__(self, cfg: Dict, inputs, system, device):
        rows = [int(u.shape[0]) for u, _, _ in inputs.traffic.splits["train"]]
        n, b = sum(rows), cfg["batch_size"]
        d, h = cfg["user_dim"], cfg["hidden"]
        steps = sum(-(-r // b) for r in rows)
        self.work = dict(examples=2 * n, flops=2 * n * 6 * (3 * d * h + h),
                         phase_examples={"dn": n, "dr": n})
        self.steps = 2 * steps

    def __call__(self, states, full: bool = False) -> yardstick.Work:
        w = yardstick.Work(**self.work)
        w.phase_examples = dict(w.phase_examples)
        if full:
            w.batches = self.steps
        return w


# ---- the test ----


@pytest.fixture
def toy(monkeypatch, tmp_path):
    """The toy cell, found by name through ``harness.find_cell``."""
    me = sys.modules[__name__]
    for _, folder in harness.PARTS:
        monkeypatch.setitem(sys.modules, f"portbench.{folder}.{NAME}", me)
    path = tmp_path / "toy-star.json"
    path.write_text(json.dumps(CONFIG))
    real = harness._load_json(harness.ROOT, "BENCHMARK.json")
    metrics = {k: [{n: v for n, v in m.items() if n != "workloads"} for m in real[k]]
               for k in ("end_to_end", "per_layer")}
    bench = {"configs": [{"name": "toy-star", "file": str(path)}],
             "workloads": [{"name": CELL, "config": "toy-star", "traffic": "epoch-balanced",
                            "chips": 1}], **metrics}
    cell = harness.find_cell(CELL, bench)
    assert all(getattr(cell.parts, key) is me for key, _ in harness.PARTS)
    return dataclasses.replace(cell, traffic=dict(cell.traffic, rows_per_domain=150))


@pytest.mark.parametrize("traced", [False, True])
def test_a_second_model_runs_through_the_harness(toy, traced):
    res = harness.run_cell(toy, SEED, 0.3, traced, CPU, 0.0, limits=LIMITS)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1, res
    assert list(res["check"]) == ["param_gap"]
    assert res["check"]["param_gap"]["value"] < 1e-5
    if traced:
        # no card and no kernel of the port: only the host-clock phase rates
        assert set(res["metrics"]) == {"dn_ex_per_s", "dr_ex_per_s"}
    else:
        assert set(res["metrics"]) == {"train_ex_per_s", "setup_s"}
        assert res["metrics"]["train_ex_per_s"]["value"] > 0


def test_the_toys_control_and_fault_are_not_correct(toy, monkeypatch):
    rows = {k: n for k, n, _ in control.readings(toy, SEED, CPU, True)}
    assert harness.judge(rows["program"], LIMITS)
    assert not harness.judge(rows["half_batch"], LIMITS), rows
    assert rows["half_batch"]["param_gap"] > 100 * rows["program"]["param_gap"]
    monkeypatch.setattr(System, "fault", "half_batch")
    res = harness.run_cell(toy, SEED, 0.1, False, CPU, 0.0, limits=LIMITS)
    assert res["correct"] is False
    assert not math.isnan(res["check"]["param_gap"]["value"])


def test_the_toys_work_count(toy):
    inp = harness.make_inputs(toy, SEED, CPU)
    rows = [int(u.shape[0]) for u, _, _ in inp.traffic.splits["train"]]
    assert rows == [90] * CONFIG["n_domain"]
    w = Counter(toy.config, inp, None, CPU)(None, full=True)
    assert w.examples == 2 * sum(rows) and w.batches == 2 * 4 * 3 and w.lane_steps == 0
    assert w.phase_examples == {"dn": sum(rows), "dr": sum(rows)} and not w.least_s
