"""The comparison of MAMDR epochs on the MLP tower: what the program's
first epochs produced against the reference on the same inputs.

The program's trajectory cannot be followed far: two runs of the program on
one seed part by a percent of the losses within one epoch (Adam turns the
last bits of reordered sums into steps of order lr where a gradient is near
0, and dropout and ReLU carry them on). So the tower kernel's first calls
(the first two DN steps of the first epoch and every lane of its first DR
lane-step) are compared one by one against the reference on the same
inputs, as is that first DR lane-step's update of every lane's state, and
the trajectory only by what a fault moves far:

- ``feed_gap``: what those calls were fed against what the reference
  derives from the run's inputs alone: labels, weights and dropout seeds of
  every recorded call, the first step's field rows and weights, and, on
  each lane of the first DR lane-step, the field rows gathered from the
  lane-stacked tables (K2) and the weights, against the rows that the
  reference's ids pick from the lane's recorded state (an exact
  comparison);
- ``tower_rows_off``: the largest share, over the calls, of rows that hold
  data whose input gradient differs from the reference tower's on the
  call's own inputs by more than 1e-4 of the row's norm. A row whose
  pre-activation sits on a ReLU's edge can go either way (its whole
  backward then differs), so a share is compared and not a norm;
- ``adam_step_gap``: the second DN step's weights against the reference's
  Adam step (each leaf's gap over the step's own size) and its field rows
  against the reference's (each field's gap over how far its rows moved, or
  over their size where they did not): the median of these parts, since
  Adam's first step is the sign of the gradient and an element whose
  gradient is nought to rounding flips;
- ``dr_step_gap``: each lane of the first DR lane-step, its state after
  the step against the reference's step from the lane's recorded state
  before it, fed the tower call's outputs (whose input gradient
  ``tower_rows_off`` judges): the field rows' gradients added into the
  tables at the reference's ids, l2, Adam and the all-pad gate, over the
  lane-stacked tables (the rows the batch touches and 1024 drawn from a
  fixed seed), the domain table and the tower. Each leaf's parameters'
  gap over the reference's step of them, and its slots' gap over their
  size, the largest over the leaves and lanes; a count that is not the
  reference's reads inf;
- ``shared_gap`` and ``specific_gap``: the norm of each leaf's change of
  ``shared``, and of each domain's specific leaves, after the last set-up
  epoch: the gap of the two norms over the larger of the reference's norm
  of that leaf and of the median leaf, the largest.

Read too, and printed, not compared: ``tower_loss_gap`` (the largest
|loss - reference| / reference over the calls, on each call's own inputs;
the TF32 control reads it no higher than the program on the a13 cells),
``tower_grad_gap`` (the weight gradients' largest relative gap over the
calls, which one ReLU edge moves by a row's share), ``loss_gap`` (every DN
loss of the set-up epochs) and ``moment_gap`` (Adam's first moment after
the first epoch, by leaf), which the trajectory's divergence sets.

A leaf whose reference moment is under a thousandth of the median leaf's
has a gradient that is nought to rounding: Adam moves it by round-off
alone, so it is left out of the changes (none is, on the benchmark's
configurations; the count is printed).

The controls (``control.py``) are the reference with its products in TF32,
with the DR lanes' Adam slots in bfloat16, and with the second half of every
batch left out.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch

NUMBERS = ("feed_gap", "tower_rows_off", "adam_step_gap", "dr_step_gap", "shared_gap",
           "specific_gap")
CONTROLS = (("tf32", {"precision": "tf32"}), ("bf16_slots", {"slots": "bfloat16"}),
            ("half_batch", {"fault": "half_batch"}))
ROW_OFF = 1e-4
NEGLIGIBLE = 1e-3
TINY = 1e-30


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def _nan_max(values) -> float:
    worst = 0.0
    for v in values:
        if math.isnan(v):
            return math.inf
        worst = max(worst, v)
    return worst


def norm_gap(prog: Dict[str, float], ref: Dict[str, float], keys) -> float:
    keys = list(keys)
    med = _median([ref[k] for k in keys])
    return _nan_max(abs(prog.get(k, math.nan) - ref[k]) / max(ref[k], med, TINY) for k in keys)


def _norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def rel(p: torch.Tensor, r: torch.Tensor, scale: float = None) -> float:
    if p.shape != r.shape:
        return math.inf
    return _norm(p.to(r.device) - r) / max(_norm(r) if scale is None else scale, TINY)


Tower = Callable[..., Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]]


def _outputs(call: Dict, tower: Tower) -> Tuple[float, float, float]:
    """(share of rows off, loss gap, weight-gradient gap) of a call's
    outputs against the reference's tower on its inputs."""
    loss, dx, grads = tower(call["x"], call["label"], call["weight"], call["seeds"],
                            call["dense"])
    pdx = call["dx"].to(dx.device)
    rows = call["weight"].to(dx.device) > 0
    if pdx.shape != dx.shape:
        return math.inf, math.inf, math.inf
    err = torch.linalg.vector_norm((pdx - dx).double(), dim=-1)
    size = torch.linalg.vector_norm(dx.double(), dim=-1)
    off = (err > ROW_OFF * size) | ~torch.isfinite(err)
    share = float((off & rows).sum()) / max(int(rows.sum()), 1)
    grad = _nan_max(rel(g, r) for g, r in zip(call["grads"], grads))
    return share, rel(call["loss"].reshape(()), loss), grad


def _feed(p: Dict, r: Dict) -> float:
    """Labels, weights and seeds of two calls."""
    seeds = 0.0 if list(p["seeds"]) == list(r["seeds"]) else 1.0
    return _nan_max([rel(p["label"], r["label"]), rel(p["weight"], r["weight"]), seeds])


def _fields(p: Dict, r: Dict) -> List[float]:
    """Field rows, each field's gap over how far its rows moved from the
    start's tables (or over their size where they did not)."""
    x, xr, x0 = p["x"], r["x"], r["x_start"]
    if x.shape != xr.shape:
        return [math.inf]
    d = xr.shape[-1] // 3
    parts = []
    for f in range(3):
        cols = slice(f * d, (f + 1) * d)
        moved = _norm(xr[:, cols] - x0[:, cols])
        parts.append(rel(x[:, cols], xr[:, cols], moved if moved > 0 else None))
    return parts


def lane_numbers(prog_calls: List[Dict], lanes: List[Dict], ref_calls: List[Dict],
                 reference) -> Tuple[List[float], float]:
    """(feed parts, step gap) of the first DR lane-step's lanes."""
    if not lanes or len(lanes) != len(prog_calls) or len(lanes) > len(ref_calls):
        return [math.inf], math.inf
    feed, gaps = [], []
    names = reference.tower_names
    for call, lane, r in zip(prog_calls, lanes, ref_calls):
        pre, post, rows = lane["pre"], lane["post"], lane["rows"]
        x = reference.lane_fields(pre["p"], rows, r["uid"], r["pid"], r["dom"])
        feed.append(math.inf if x is None else rel(call["x"], x))
        feed += [rel(a, pre["p"][n]) for a, n in zip(call["dense"], names)]
        want = reference.lane_step(pre, rows, call["dx"], call["grads"], r["uid"], r["pid"],
                                   r["dom"], r["weight"])
        if want is None or post["count"] != want["count"]:
            gaps.append(math.inf)
            continue
        for n in want["p"]:
            step = _norm(want["p"][n] - pre["p"][n])
            gaps += [rel(post["p"][n], want["p"][n], step), rel(post["mu"][n], want["mu"][n]),
                     rel(post["nu"][n], want["nu"][n])]
    return feed, _nan_max(gaps)


def step_numbers(prog, ref, reference) -> Dict[str, float]:
    prog_calls, ref_calls = prog.calls, ref.calls
    pdn, rdn, pdr, rdr = prog_calls["dn"], ref_calls["dn"], prog_calls["dr"], ref_calls["dr"]
    names = ("feed_gap", "tower_rows_off", "tower_loss_gap", "adam_step_gap", "tower_grad_gap",
             "dr_step_gap")
    if len(pdn) < 2 or len(rdn) < 2 or not pdr or len(pdr) > len(rdr):
        return {n: math.inf for n in names}
    p0, r0, p1, r1 = pdn[0], rdn[0], pdn[1], rdn[1]
    pairs = [(p0, r0), (p1, r1)] + list(zip(pdr, rdr))
    feed = [_feed(p, r) for p, r in pairs] + [rel(p0["x"], r0["x"])]
    feed += [rel(a, b) for a, b in zip(p0["dense"], r0["dense"])]
    lane_feed, dr_step = lane_numbers(pdr, prog.lanes, rdr, reference)
    outs = [_outputs(p, reference.tower_grads) for p, _ in pairs]
    steps = [rel(a, b, _norm(b - c)) for a, b, c in zip(p1["dense"], r1["dense"], r0["dense"])]
    adam = steps + _fields(p1, r1)
    return {"feed_gap": _nan_max(feed + lane_feed),
            "tower_rows_off": _nan_max(o[0] for o in outs),
            "tower_loss_gap": _nan_max(o[1] for o in outs),
            "adam_step_gap": math.inf if any(map(math.isnan, adam)) else _median(adam),
            "tower_grad_gap": _nan_max(o[2] for o in outs),
            "dr_step_gap": dr_step}


def compare(prog, ref, reference) -> Tuple[Dict[str, float], int]:
    """({number: value}, leaves left out) of two ``Readings``: NUMBERS and
    the numbers read, not compared; ``reference`` is the float32 reference
    that made ``ref`` (its tower and its lane step judge the program's
    steps)."""
    loss = math.inf if len(prog.losses) != len(ref.losses) else _nan_max(
        abs(p - r) / max(abs(r), TINY) for pe, re in zip(prog.losses, ref.losses)
        for p, r in zip(pe, re))
    med = _median(list(ref.moment.values()))
    kept = [n for n, v in ref.moment.items() if v >= NEGLIGIBLE * med]
    spec_keys = [k for k in ref.specific_change if k.split("/", 1)[1] in kept]
    out = step_numbers(prog, ref, reference)
    out.update({"shared_gap": norm_gap(prog.shared_change, ref.shared_change, kept),
                "specific_gap": norm_gap(prog.specific_change, ref.specific_change, spec_keys),
                "loss_gap": loss,
                "moment_gap": norm_gap(prog.moment, ref.moment, ref.moment)})
    return out, len(ref.moment) - len(kept)
