"""The work of MAMDR epochs on the MLP tower, counted from shapes and from
the epoch's own draws.

An MLP example's operations are the forward product, the input gradient
and the weight gradient of each layer, each counted once: 6 * multiply-adds
a row (0.856 GFLOP a 1024-row batch at 384-256-128-64-1), whatever products
an implementation splits them into.

``EpochWork`` replays an epoch's draws (the same order, support domains and
shuffle keys the program drew, from the generators' saved states, with the
reference's batch formation) and counts, per call of the tower kernel (K1)
and of the field gather (K2), only what the inputs need: rows that carry
data, lanes that hold any, and each table row that a call's real ids touch,
read once. Each such call is one Adam step of every lane that holds data.
DR lane-steps run in the program's groups of lanes, every lane's shuffle
keys drawn before the first group; where the program runs DR sequentially,
one lane a step, each run draws its keys as it starts, and so does the
replay.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from portbench.reference.mamdr_mlp import Draws, batch_positions
from portbench.yardstick import F32, HBM_BYTES_PER_S, PEAK_TF32_FLOPS, Work


def tower_macs(dims: Sequence[int]) -> int:
    """Multiply-adds of one row's forward pass: the layers and the 1-unit logit."""
    return sum(a * b for a, b in zip(dims[:-1], dims[1:])) + dims[-1]


def tower_params(dims: Sequence[int]) -> int:
    return tower_macs(dims) + sum(dims[1:])


def example_flops(dims: Sequence[int]) -> int:
    """Forward and backward operations of one example (6 per multiply-add)."""
    return 6 * tower_macs(dims)


def k1_bytes(lane_rows: Sequence[int], dims: Sequence[int]) -> int:
    """A K1 call's least traffic: for each lane with data, its rows' inputs
    read and input gradients written, their labels and weights, and the
    lane's weights read and weight gradients written."""
    per_row = (2 * dims[0] + 2) * F32
    return sum(r * per_row + 2 * tower_params(dims) * F32 for r in lane_rows if r > 0)


def k1_least_s(lane_rows: Sequence[int], dims: Sequence[int]) -> float:
    flops = example_flops(dims) * sum(lane_rows)
    return max(flops / PEAK_TF32_FLOPS, k1_bytes(lane_rows, dims) / HBM_BYTES_PER_S)


def k2_bytes(n_ids: int, unique_rows: Sequence[int], widths: Sequence[int],
             trained: Sequence[bool]) -> int:
    """A K2 call's least traffic for ``n_ids`` real ids a field: each table
    row the ids touch read once, the ids read, the output written once, and
    the flat row ids written for each field that trains."""
    rows = sum(u * w for u, w in zip(unique_rows, widths)) * F32
    return rows + n_ids * F32 * len(widths) + n_ids * sum(widths) * F32 + n_ids * F32 * sum(trained)


def plan_examples(order: List[int], aux: List[List[int]], n_train: Sequence[int],
                  batch: int, reg_step: int) -> Dict[str, int]:
    """Examples an epoch trains, as the port's bench counts them: every real
    row of a DN step or of a DR lane-step."""
    dn = sum(n_train[d] for d in order)
    cap = reg_step * batch if reg_step > 0 else None
    dr = sum(n_train[s] + (n_train[q] if cap is None else min(cap, n_train[q]))
             for q, row in zip(order, aux) for s in row)
    return {"dn": dn, "dr": dr}


class EpochWork:
    """Replays epochs' draws over the train columns to count their work."""

    def __init__(self, cfg: Dict, train, batch: int, device):
        self.cfg, self.batch, self.device = cfg, batch, device
        self.n_real = [int(u.shape[0]) for u, _, _ in train]
        self.steps = [-(-n // batch) for n in self.n_real]
        self.n_pad = max(self.steps) * batch
        self.cols = []
        for u, p, _ in train:
            wrap = torch.arange(self.n_pad, device=device) % u.shape[0]
            self.cols.append((u[wrap].long(), p[wrap].long()))
        emb = cfg["user_dim"]
        self.dims = (3 * emb, *cfg["hidden_dim"])
        self.widths = (emb, emb, emb)
        self.tables_train = bool(cfg["emb_trainable"])
        self.trained = (self.tables_train, self.tables_train, True)
        self.n_rows = (cfg["n_uid"], cfg["n_pid"])

    def _call(self, runs, s: int) -> Work:
        """One lane-step: ``runs`` is [(domain, positions [steps, B])] a lane."""
        lane_rows, uids, pids = [], [], []
        for lane, (dom, pos) in enumerate(runs):
            rows = 0
            if s < pos.shape[0]:
                rows = max(0, min(self.batch, self.n_real[dom] - s * self.batch))
            lane_rows.append(rows)
            if rows:
                u, p = self.cols[dom]
                ids = pos[s, :rows]
                # a lane-stacked (trained) table is its own rows: offset by lane
                off = lane * max(self.n_rows) if self.tables_train else 0
                uids.append(u[ids] + off)
                pids.append(p[ids] + off)
        n_ids = sum(lane_rows)
        if not n_ids:
            return Work()
        uniq = [int(torch.unique(torch.cat(uids)).numel()),
                int(torch.unique(torch.cat(pids)).numel()),
                sum(1 for r in lane_rows if r)]
        k2 = k2_bytes(n_ids, uniq, self.widths, self.trained) / HBM_BYTES_PER_S
        return Work(batches=1, lane_steps=sum(1 for r in lane_rows if r),
                    least_s={"k1": k1_least_s(lane_rows, self.dims), "k2": k2})

    def _examples(self, order, aux) -> Work:
        ex = plan_examples(order, aux, self.n_real, self.batch,
                           self.cfg["domain_regulation_step"])
        n = ex["dn"] + ex["dr"]
        return Work(examples=n, flops=n * example_flops(self.dims), phase_examples=ex)

    def _plan(self, draws: Draws):
        c = self.cfg
        return draws.plan(len(self.n_real), c["sample_num"], c["add_query_domain"],
                          c["shuffle_sequence"])

    def examples(self, np_state) -> Work:
        """The examples of the one epoch whose host draws start at this state."""
        return self._examples(*self._plan(Draws.from_states(np_state, None, self.device)))

    def replay(self, np_state, gen_state, group: Optional[int]) -> Work:
        """The work of the one epoch whose draws start at these states,
        with DR lanes in groups of ``group`` (0: all at once; None: DR
        sequential)."""
        draws = Draws.from_states(np_state, gen_state, self.device)
        n_dom = len(self.n_real)
        reg_step = self.cfg["domain_regulation_step"]
        order, aux = self._plan(draws)
        work = self._examples(order, aux)
        b = self.batch
        for d in order:
            pos = batch_positions(draws.keys((self.n_pad,)), self.n_real[d], self.n_pad, b,
                                  self.steps[d])
            for s in range(self.steps[d]):
                work.add(self._call([(d, pos)], s))
        if group is None:
            for q, row in zip(order, aux):
                for s_dom in row:
                    for dom, cap in ((s_dom, 0), (q, reg_step)):
                        steps = self.steps[dom] if cap <= 0 else min(cap, self.steps[dom])
                        pos = batch_positions(draws.keys((self.n_pad,)), self.n_real[dom],
                                              self.n_pad, b, steps)
                        for s in range(steps):
                            work.add(self._call([(dom, pos)], s))
            return work
        k = len(aux[0])
        keys = [draws.keys((n_dom, self.n_pad)) for _ in range(2 * k)]
        g = n_dom if group <= 0 else group
        for start in range(0, n_dom, g):
            lanes = range(start, min(start + g, n_dom))
            for j in range(k):
                for kind, cap in ((0, 0), (1, reg_step)):
                    runs = []
                    for l in lanes:
                        dom = aux[l][j] if kind == 0 else order[l]
                        steps = self.steps[dom] if cap <= 0 else min(cap, self.steps[dom])
                        runs.append((dom, batch_positions(keys[2 * j + kind][l], self.n_real[dom],
                                                          self.n_pad, b, steps)))
                    for s in range(max(pos.shape[0] for _, pos in runs)):
                        work.add(self._call(runs, s))
        return work


class Counter:
    """Counts the work of epochs from the generators' states before each:
    the examples from the host draws alone, or (``full``) every K1 and K2
    call's least time and every Adam lane-step from a replay of all the
    draws."""

    def __init__(self, cfg: Dict, inputs, system, device):
        self.work = EpochWork(cfg, inputs.traffic.splits["train"], cfg["batch_size"], device)
        self.group = system.group()

    def __call__(self, states, full: bool = False) -> Work:
        if full:
            return self.work.replay(*states, self.group)
        return self.work.examples(states[0])
