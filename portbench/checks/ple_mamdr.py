"""The comparison of MAMDR epochs on PLE: what the program's first epochs
produced against the reference on the same inputs.

As on the MLP (``checks/mamdr_mlp.py``), the program's trajectory cannot be
followed far: two runs on one seed part by a percent within an epoch (Adam
turns the last bits of reordered sums into steps of order lr where a
gradient is near 0). So the first epoch's first two DN steps and every lane
of its first DR lane-step are compared one by one against the reference on
their own inputs, and the trajectory only by what a fault moves far:

- ``feed_gap``: what those steps were fed against what the reference
  derives from the run's inputs alone: ids, domain, labels, weights and
  dropout seeds of every step; the field rows the program gathered (K2)
  against those the reference's ids pick from the step's recorded state;
  and the first DN step's state against the start (an exact comparison);
- ``rows_off``: the largest share, over the steps, of rows that hold data
  whose input gradient dx differs from the reference's (on the step's own
  inputs: its field rows, dense leaves, labels, weights and seeds) by more
  than 1e-4 of the row's norm. A pre-activation on a ReLU's edge can go
  either way and move its row's whole gradient, so a share is compared;
- ``step_gap``: each step's state after it against the reference's step
  from the state before it, fed the step's own dx and dense gradients: the
  field rows' gradients added into the tables at the reference's ids, l2,
  Adam and the all-pad gate, over the tables (the rows the batch touches
  and 1024 drawn from a fixed seed) and every dense leaf. Each leaf's
  parameters' gap over the reference's step of them, its slots' gap over
  their size, the largest over leaves and steps; a count that is not the
  reference's reads inf;
- ``grad_gap``: each dense leaf's gradient (the experts', gates' and
  towers', which ``step_gap`` takes as the program gave them and Adam's
  step does not scale with) against the reference's on each step's own
  inputs, the relative gap; of each leaf and phase the lower median over
  the phase's steps (DN's two, DR's lanes), the largest. The first DN
  step, from the initial weights, reads up to 5.6e-4 in the task experts
  on some seeds where every other step reads about 1e-6 (on the card);
  a fault moves every step of its phase;
- ``shared_gap`` and ``specific_gap``: the norm of each leaf's change of
  ``shared``, and of each domain's specific leaves, after the last set-up
  epoch: the gap of the two norms over the larger of the reference's norm
  of that leaf and of the median leaf, the largest.

Read too, and printed, not compared: ``step_loss_gap`` (each step's data
loss against the reference's on its own inputs), ``loss_gap`` (every DN
loss of the set-up epochs) and ``moment_gap`` (Adam's first moment after
the first epoch, by leaf).

A leaf whose reference moment is under a thousandth of the median leaf's
is left out of the changes, as on the MLP: here both gates (the task gate's
gradient scales with the 1e-4 table rows twice over; the shared gate, which
with one level feeds nothing, has none at all).

The controls (``control.py``) are the reference with its expert products in
TF32, with the DR lanes' Adam slots in bfloat16, and with the second half of
every batch left out.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

import torch

from portbench.checks.mamdr_mlp import (NEGLIGIBLE, TINY, _median, _nan_max, _norm, norm_gap,
                                        rel)

NUMBERS = ("feed_gap", "rows_off", "step_gap", "grad_gap", "shared_gap", "specific_gap")
CONTROLS = (("tf32", {"precision": "tf32"}), ("bf16_slots", {"slots": "bfloat16"}),
            ("half_batch", {"fault": "half_batch"}))
ROW_OFF = 1e-4


def _same(a: torch.Tensor, b: torch.Tensor) -> float:
    """0 where two id columns are equal, else 1."""
    return 0.0 if a.shape == b.shape and bool(torch.equal(a.to(b.device), b)) else 1.0


def _feed(p: Dict, r: Dict, reference) -> List[float]:
    parts = [_same(p["uid"], r["uid"]), _same(p["pid"], r["pid"]),
             0.0 if p["dom"] == r["dom"] else 1.0,
             0.0 if list(p["seeds"]) == list(r["seeds"]) else 1.0,
             rel(p["label"], r["label"]), rel(p["weight"], r["weight"])]
    x = reference.lane_fields(p["pre"]["p"], p["rows"], r["uid"], r["pid"], r["dom"])
    parts.append(math.inf if x is None else rel(p["x"], x))
    return parts


def _rows_off(p: Dict, dx: torch.Tensor) -> float:
    pdx = p["dx"].to(dx.device)
    if pdx.shape != dx.shape:
        return math.inf
    rows = p["weight"].to(dx.device) > 0
    err = torch.linalg.vector_norm((pdx - dx).double(), dim=-1)
    size = torch.linalg.vector_norm(dx.double(), dim=-1)
    off = (err > ROW_OFF * size) | ~torch.isfinite(err)
    return float((off & rows).sum()) / max(int(rows.sum()), 1)


def _step_gap(p: Dict, r: Dict, reference) -> float:
    pre, post = p["pre"], p["post"]
    grads = [p["grads"][n] for n in reference.tower_names]
    want = reference.lane_step(pre, p["rows"], p["dx"], grads, r["uid"], r["pid"], r["dom"],
                               r["weight"])
    if want is None or post["count"] != want["count"]:
        return math.inf
    gaps = []
    for n in want["p"]:
        step = _norm(want["p"][n] - pre["p"][n])
        gaps += [rel(post["p"][n], want["p"][n], step), rel(post["mu"][n], want["mu"][n]),
                 rel(post["nu"][n], want["nu"][n])]
    return _nan_max(gaps)


def step_numbers(prog, ref, reference) -> Dict[str, float]:
    """The recorded steps' numbers: the program's first two DN steps and
    the lanes of its first DR lane-step, each against the reference's step
    of the same place."""
    names = ("feed_gap", "rows_off", "step_gap", "grad_gap", "step_loss_gap")
    pdn, rdn, pdr, rdr = prog.calls["dn"], ref.calls["dn"], prog.calls["dr"], ref.calls["dr"]
    if len(pdn) < 2 or len(rdn) < 2 or not pdr or len(pdr) > len(rdr):
        return {n: math.inf for n in names}
    pairs = list(zip(pdn[:2], rdn[:2])) + list(zip(pdr, rdr))
    start = [rel(pdn[0]["pre"][k][n], rdn[0]["pre"][k][n])
             for k in ("p", "mu", "nu") for n in rdn[0]["pre"][k]]
    feed, off, steps, loss = start, [], [], []
    grad: Dict[Tuple[str, str], List[float]] = {}  # (phase, leaf): a gap a step
    for phase, (p, r) in zip(["dn"] * 2 + ["dr"] * len(pdr), pairs):
        feed += _feed(p, r, reference)
        rloss, rdx, rgrads = reference.step_grads(p)
        off.append(_rows_off(p, rdx))
        for n, g in rgrads.items():
            grad.setdefault((phase, n), []).append(rel(p["grads"][n], g))
        loss.append(rel(p["loss"].reshape(()), rloss))
        steps.append(_step_gap(p, r, reference))
    return {"feed_gap": _nan_max(feed), "rows_off": _nan_max(off), "step_gap": _nan_max(steps),
            "grad_gap": _nan_max(_median_low(g) for g in grad.values()),
            "step_loss_gap": _nan_max(loss)}


def _median_low(gaps: List[float]) -> float:
    """The lower median of a leaf's gaps over a phase's steps (inf for a NaN)."""
    if any(map(math.isnan, gaps)):
        return math.inf
    return statistics.median_low(gaps)


def compare(prog, ref, reference) -> Tuple[Dict[str, float], int]:
    """({number: value}, leaves left out) of two ``Readings``: NUMBERS and
    the numbers read, not compared; ``reference`` is the float32 reference
    that made ``ref``."""
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
