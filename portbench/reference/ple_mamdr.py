"""Plain PyTorch reference of MAMDR epochs on PLE.

What one epoch of ``ple_meta_mamdr_finetune`` computes, written out from the
method's descriptions (PLE: Tang et al., RecSys 2020; MAMDR, ICDE'23) with
nothing of the program under test:

- the fields: the user, item and domain rows concatenated, x [B, 3D];
- one CGC level for the batch's domain d (a batch is one domain's): its
  ``t`` task experts relu(x W_d,k + b_d,k) and the ``s`` shared experts
  relu(x S_k + c_k), each [B, h]; the gate softmax(x G_d) over those t + s
  experts; the mix, the experts weighted by the gate and summed;
- domain d's tower: Dense -> ReLU -> inverted hash dropout per hidden layer,
  then a bias-free one-unit logit. The dropout mask of a layer is drawn over
  every task's tower at once, [T, B, units], and domain d's rows are d's;
- the loss: the weighted mean binary cross-entropy over the batch's rows
  plus l2 (1e-5) on the trainable embedding tables. Every leaf's gradient by
  autograd of those equations; a leaf the batch's domain does not reach
  (the other domains' experts, gates and towers, and the shared gate, which
  with one level feeds nothing) gets zeros;
- Adam over every trainable leaf and MAMDR's epochs (DN, then DR with every
  query domain from the post-DN state): ``mamdr_mlp``'s reference, which
  ``Reference`` subclasses, with its draws, batch formation, dropout seeds,
  merges into ``shared`` and the specifics.

The reference runs in float32 with TF32 off. ``precision`` "tf32" rounds
the expert products' operands to TF32 (the control; the same on the CPU
and the card); ``slots`` "bfloat16" keeps the
DR lanes' Adam slots in bfloat16; ``fault`` "half_batch" drops the second
half of every batch.

The first epoch's first two DN steps and each query domain's first DR step
are recorded (``Readings.calls``): the batch, its dropout seeds, the field
rows x and their gradient dx, the data loss, the dense leaves' gradients,
and the lane's state before and after the step in pieces (``lane_pieces``;
a table as the rows the batch touches and 1024 drawn from a fixed seed).
``step_grads`` is the reference's gradient on a recorded step's own inputs,
``lane_fields`` its field rows from recorded pieces, and ``lane_step`` its
Adam step of recorded pieces fed a step's dx and dense gradients: the
comparison holds the program's recorded steps to them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from portbench.reference import mamdr_mlp
from portbench.reference.hashdrop import IOTA_MUL, MASK32, fmix32, mul32, step_seeds
from portbench.reference.mamdr_mlp import (TABLES, Problem, Readings, Tree, _Lane, _precision,
                                           _tf32, adam, batch_positions, table_rows)

TRUNC_STD = 0.87962566103423978  # stddev of a unit normal truncated to [-2, 2]


def leaf_order(n_tower: int) -> Tuple[str, ...]:
    """Every leaf's name: the tables, the level's experts and gates, the towers."""
    towers = [n for i in range(n_tower) for n in (f"tower_kernel_{i}", f"tower_bias_{i}")]
    return TABLES + ("task_expert_kernel_0", "task_expert_bias_0", "shared_expert_kernel_0",
                     "shared_expert_bias_0", "task_gate_kernel_0",
                     "shared_gate_kernel_0") + tuple(towers) + ("tower_logit",)


def shapes(cfg: Dict) -> Dict[str, Tuple[int, ...]]:
    if cfg["num_levels"] != 1:
        raise ValueError("the reference writes out one CGC level")
    T, t, s = cfg["n_domain"], cfg["specific_expert_num"], cfg["shared_expert_num"]
    d_in, h, dim = 3 * cfg["user_dim"], cfg["hidden_dim"][0], cfg["user_dim"]
    out = {"user_emb": (cfg["n_uid"], dim), "item_emb": (cfg["n_pid"], dim),
           "domain_emb": (T, dim),
           "task_expert_kernel_0": (T, t, d_in, h), "task_expert_bias_0": (T, t, h),
           "shared_expert_kernel_0": (s, d_in, h), "shared_expert_bias_0": (s, h),
           "task_gate_kernel_0": (T, d_in, t + s), "shared_gate_kernel_0": (d_in, T * t + s)}
    prev = h
    for i, units in enumerate(cfg["tower_hidden_dim"]):
        out[f"tower_kernel_{i}"] = (T, prev, units)
        out[f"tower_bias_{i}"] = (T, units)
        prev = units
    out["tower_logit"] = (T, prev, 1)
    return out


def trainable(cfg: Dict) -> List[str]:
    frozen = () if cfg["emb_trainable"] else ("user_emb", "item_emb")
    return [n for n in leaf_order(len(cfg["tower_hidden_dim"])) if n not in frozen]


def _fans(shape: Sequence[int]) -> Tuple[int, int]:
    """A kernel's (fan_in, fan_out) with its input axis -2 and its output
    axis -1, each times the product of the other axes (flax's fans, which
    the program's initialisers take)."""
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def _init(name: str, shape: Tuple[int, ...], g: torch.Generator, device) -> torch.Tensor:
    """A table N(0, 1e-4) (deepctr's embedding default), a bias 0, the logit
    kernel glorot-normal (a normal truncated at two deviations), every other
    kernel glorot-uniform."""
    if name in TABLES:
        return torch.randn(shape, generator=g, device=device) * 1e-4
    if "bias" in name:
        return torch.zeros(shape, device=device)
    fan_in, fan_out = _fans(shape)
    if name == "tower_logit":
        std = math.sqrt(2.0 / (fan_in + fan_out)) / TRUNC_STD
        return torch.nn.init.trunc_normal_(torch.empty(shape, device=device), 0.0, std,
                                           -2.0 * std, 2.0 * std, generator=g)
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return (torch.rand(shape, generator=g, device=device) * 2.0 - 1.0) * limit


def make_weights(cfg: Dict, traffic, seed: int, device) -> Tuple[Tree, Tree, List[Tree]]:
    """(frozen tables, shared start, each domain's specific start): every
    trainable leaf drawn by the program's initialisers (``_init``) into
    ``shared``; each domain's specific start zeros (``specific_init``
    "zeros") or a fresh draw ("random"). Frozen tables are the traffic's
    pretrained ones."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    shp, names = shapes(cfg), trainable(cfg)
    shared = {n: _init(n, shp[n], g, device) for n in names}
    if cfg["specific_init"] == "zeros":
        specific = [{n: torch.zeros_like(x) for n, x in shared.items()}
                    for _ in range(cfg["n_domain"])]
    elif cfg["specific_init"] == "random":
        specific = [{n: _init(n, shp[n], g, device) for n in names}
                    for _ in range(cfg["n_domain"])]
    else:
        raise ValueError(f"unknown specific_init {cfg['specific_init']!r}")
    frozen = {} if cfg["emb_trainable"] else dict(traffic.tables)
    return frozen, shared, specific


def problem(cfg: Dict, inputs) -> Problem:
    """The MLP reference's problem of the run, its ``hidden`` the towers'
    widths."""
    return mamdr_mlp.problem(dict(cfg, hidden_dim=cfg["tower_hidden_dim"]), inputs)


class TaskMasks:
    """Keep masks of one dropout layer drawn over every task's tower at once
    ([T, B, units], the flat row-major counter of ``hashdrop``), cut to
    one task's rows."""

    def __init__(self, n_task: int, rows: int, units: int, rate: float, device):
        self.rows, self.units, self.rate = rows, units, rate
        idx = torch.arange(n_task * rows * units, dtype=torch.int64, device=device)
        self.base = mul32(idx, IOTA_MUL).view(n_task, rows * units)

    def of(self, task: int, seeds: List[int]) -> torch.Tensor:
        """[len(seeds), rows, units] masks of ``task`` as float (0 or 1)."""
        s = torch.tensor([v & MASK32 for v in seeds], dtype=torch.int64,
                         device=self.base.device)
        x = fmix32((self.base[task][None, :] + s[:, None]) & MASK32)
        u = (x >> 8).to(torch.float32) * (1.0 / (1 << 24))
        return (u >= self.rate).to(torch.float32).view(len(seeds), self.rows, self.units)


class Reference(mamdr_mlp.Reference):
    """The MLP reference's flat vectors, pieces, lane step and epochs over
    PLE's leaves (``tower_names``: every leaf but the tables), with PLE's
    model step."""

    def __init__(self, prob: Problem, precision: str = "float32",
                 fault: Optional[str] = None, slots: str = "float32"):
        if precision not in ("float32", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        super().__init__(prob, precision, fault, slots)
        self.names = [n for n in leaf_order(len(prob.hidden)) if n in prob.shared0]
        self.tower_names = [n for n in self.names if n not in TABLES]
        if set(self.names) & set(prob.frozen):
            raise ValueError("a leaf is both frozen and trainable")
        self.shapes = {n: tuple(prob.shared0[n].shape) for n in self.names}
        sizes = [prob.shared0[n].numel() for n in self.names]
        self.offsets = dict(zip(self.names, np.cumsum([0] + sizes[:-1]).tolist()))
        self.sizes = dict(zip(self.names, sizes))
        self.n_task = prob.shared0["domain_emb"].shape[0]
        self.masks = [TaskMasks(self.n_task, prob.batch, u, prob.dropout, self.device)
                      for u in prob.hidden]

    # ---- the model ----

    def _expert_mm(self, a, b):
        if self.precision == "tf32":
            return _tf32(a) @ _tf32(b)
        return a @ b

    def logits(self, dense: Dict[str, torch.Tensor], x: torch.Tensor, dom: int,
               drop: Sequence[torch.Tensor]) -> torch.Tensor:
        """Domain ``dom``'s logits [B] on the field rows ``x`` [B, 3D], the
        dropout as float masks (0 or 1 / (1 - rate)) a tower layer."""
        mm = self._expert_mm
        task = torch.relu(mm(x, dense["task_expert_kernel_0"][dom])
                          + dense["task_expert_bias_0"][dom][:, None, :])  # [t, B, h]
        shared = torch.relu(mm(x, dense["shared_expert_kernel_0"])
                            + dense["shared_expert_bias_0"][:, None, :])  # [s, B, h]
        experts = torch.cat([task, shared])  # [t + s, B, h]
        gate = torch.softmax(x @ dense["task_gate_kernel_0"][dom], dim=-1)  # [B, t + s]
        h = torch.sum(gate.T[:, :, None] * experts, dim=0)  # [B, h]
        for i in range(len(self.prob.hidden)):
            h = torch.relu(h @ dense[f"tower_kernel_{i}"][dom] + dense[f"tower_bias_{i}"][dom])
            if drop:
                h = h * drop[i]
        return (h @ dense["tower_logit"][dom])[:, 0]

    def grads(self, dense: Dict[str, torch.Tensor], x, y, w, dom: int,
              drop: Sequence[torch.Tensor]):
        """(data loss, dloss/dx, {dense leaf: gradient}) by autograd of the
        equations; the l2 term reaches the tables alone (``lane_step``)."""
        leaves = {n: t.detach().requires_grad_(True) for n, t in dense.items()}
        xs = x.detach().requires_grad_(True)
        with torch.enable_grad():
            logit = self.logits(leaves, xs, dom, drop)
            bce = (y * torch.nn.functional.softplus(-logit)
                   + (1.0 - y) * torch.nn.functional.softplus(logit))
            loss = torch.sum(bce * w) / torch.clamp(torch.sum(w), min=1.0)
            got = torch.autograd.grad(loss, [xs, *leaves.values()], allow_unused=True)
        out = {n: torch.zeros_like(t) if g is None else g
               for (n, t), g in zip(leaves.items(), got[1:])}
        return loss.detach(), got[0], out

    def drop_masks(self, dom: int, seeds: Sequence[Sequence[int]]) -> List[torch.Tensor]:
        """[layer] masks [len(seeds), B, units] of ``dom``'s tower, a step's
        seeds (one a layer) each."""
        if not self.prob.dropout:
            return []
        return [m.of(dom, [sd[i] for sd in seeds]) * self.scale
                for i, m in enumerate(self.masks)]

    def step_grads(self, call: Dict):
        """The reference's (loss, dx, dense grads) on a recorded step's own
        inputs: its field rows, its pre-step dense leaves, its labels,
        weights and dropout seeds."""
        dense = {n: call["pre"]["p"][n] for n in self.tower_names}
        drop = [m[0] for m in self.drop_masks(call["dom"], [call["seeds"]])]
        return self.grads(dense, call["x"].to(self.device), call["label"].to(self.device),
                          call["weight"].to(self.device), call["dom"], drop)

    def _step(self, lane: _Lane, dom: int, pos: torch.Tensor, drop: Sequence[torch.Tensor],
              record: Optional[List[Dict]] = None, slots: str = "float32") -> torch.Tensor:
        """One Adam step of ``lane`` on domain ``dom``'s rows at ``pos``;
        returns the batch's data loss. With ``record``, appends the step
        with the lane's pieces before and after it."""
        prob = self.prob
        uid_p, pid_p, label_p, w_p = self.padded[dom]
        uid, pid, y, w = uid_p[pos], pid_p[pos], label_p[pos], w_p[pos]
        if self.fault == "half_batch":
            w = w * self.keep_rows
        p = lane.p
        x = self._fields(p, uid, pid, dom)
        loss, dx, grads = self.grads({n: self.leaf(p, n) for n in self.tower_names}, x, y, w,
                                     dom, drop)
        if record is not None:
            rows = {n: table_rows(ids, prob.shared0[n].shape[0])
                    for n, ids in (("user_emb", uid), ("item_emb", pid)) if n not in prob.frozen}
            record.append({"uid": uid, "pid": pid, "dom": dom, "label": y, "weight": w,
                           "seeds": step_seeds(lane.base, lane.step, len(prob.hidden)),
                           "x": x, "dx": dx, "loss": loss, "grads": grads, "rows": rows,
                           "pre": self.lane_pieces(lane, rows)})
        g = torch.zeros_like(p)
        for name, t in grads.items():
            self.leaf(g, name).copy_(t)
        d = dx.shape[1] // 3
        for f, (name, ids) in enumerate((("user_emb", uid), ("item_emb", pid))):
            if name not in prob.frozen:
                self.leaf(g, name).index_add_(0, ids, dx[:, f * d:(f + 1) * d])
        self.leaf(g, "domain_emb")[dom] += torch.sum(dx[:, 2 * d:], dim=0)
        for name in TABLES:
            if name not in prob.frozen:
                self.leaf(g, name).add_(self.leaf(p, name), alpha=2.0 * prob.l2)
        lane.count += 1
        lane.p, lane.mu, lane.nu = adam(p, lane.mu, lane.nu, g, lane.count, prob.lr, slots)
        lane.step += 1
        if record is not None:
            record[-1]["post"] = self.lane_pieces(lane, record[-1]["rows"])
        return loss

    # ---- epochs ----

    def _run(self, lane: _Lane, dom: int, keys: torch.Tensor, cap: int = 0,
             record: Optional[List[Dict]] = None, n_record: int = 0,
             lanes: Optional[List[Dict]] = None, slots: str = "float32") -> torch.Tensor:
        """An epoch on one domain (at most ``cap`` batches when positive);
        returns its mean data loss. Its first ``n_record`` steps go into
        ``record``, each with its lane's pieces (so ``lanes`` stays empty);
        Adam keeps its slots in ``slots``."""
        prob = self.prob
        steps = self.steps[dom] if cap <= 0 else min(cap, self.steps[dom])
        pos = batch_positions(keys, self.n_real[dom], self.n_pad, prob.batch, steps)
        drop = self.drop_masks(dom, [step_seeds(lane.base, lane.step + s, len(prob.hidden))
                                     for s in range(steps)])
        total = torch.zeros((), device=self.device)
        for s in range(steps):
            total = total + self._step(lane, dom, pos[s], [m[s] for m in drop],
                                       record if s < n_record else None, slots)
        return total / steps

    def run(self, epochs: int) -> Readings:
        """The epochs' readings, every product in float32 (TF32 off on the
        card; the TF32 control rounds its expert products' operands itself)."""
        with _precision("float32", self.device):
            return self._epochs(epochs)
