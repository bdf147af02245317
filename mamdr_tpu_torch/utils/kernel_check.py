"""Holding kernel K1 to its plain version where ReLU units sit on the edge.

The tower's gradients jump where a pre-activation z crosses 0. Kernel K1 and
the plain version sum each z in another order, so a z within float32
rounding of 0 can land on either side, and the backward pass of that row
then differs by far more than rounding. The plain version stays independent
of the kernel: a check computes both, finds the rows that hold such a unit
with ``relu_flip_rows`` (which refuses a sign difference away from 0),
reports their count, and compares again with those rows' batch weights set
to 0, where a row contributes to no gradient whichever way its units fall.

Used by chip_smoke.py and the tests on the card; nothing on a training path.
"""

from __future__ import annotations

import torch

RELU_EDGE_TOL = 1e-5  # of a layer's largest |z|: how far from 0 a unit may lie
                      # where two float32 sums of it disagree in sign
FLIP_SHARE = 1e-5     # of all units: how many may do so (a few in 14M are seen)


def relu_flip_rows(zs_a, zs_b, tol: float = RELU_EDGE_TOL):
    """Rows where two evaluations of the same tower take a ReLU unit
    differently.

    ``zs_a``, ``zs_b``: per-layer pre-activations [..., B, h] of the two.
    Returns (rows [..., B] bool, the number of such units). Raises if a unit
    whose sign differs lies farther than ``tol`` of its layer's largest |z|
    from 0 in either evaluation: that is a wrong z, not a rounding.
    """
    rows, count = None, 0
    for i, (a, b) in enumerate(zip(zs_a, zs_b)):
        if a.shape != b.shape:
            raise ValueError(f"layer {i + 1}: pre-activations {tuple(a.shape)} vs "
                             f"{tuple(b.shape)}")
        differs = (a > 0.0) != (b > 0.0)
        off_by = float(torch.where(differs, torch.maximum(a.abs(), b.abs()), 0.0).max())
        if off_by > tol * float(b.abs().max()):
            raise ValueError(f"layer {i + 1}: a ReLU unit differs in sign at |z| = "
                             f"{off_by:.3e}, not within rounding of 0")
        count += int(differs.sum())
        hit = differs.any(dim=-1)
        rows = hit if rows is None else rows | hit
    return rows, count


def k1_flip_rows(x, label, weight, seeds, dense, dims, rate):
    """``relu_flip_rows`` between kernel K1 and the plain version on the
    operands of ``fused_tower_grad`` (x [B, in]) or ``fused_tower_grad_lanes``
    (x [L, B, in]), on the card. K1 is asked to write its pre-activations
    out, which it does not do otherwise; the launch is not counted."""
    from mamdr_tpu_torch.ops.fused_mlp_step import _launch_k1, tower_forward_reference

    single = x.dim() == 2
    if single:
        x, label, weight, seeds = x[None], label[None], weight[None], seeds[None]
        dense = tuple(t[None] for t in dense)
    zs_k = _launch_k1(x, label, weight, seeds, dense, dims, rate, want_z=True)[3]
    per_lane = [tower_forward_reference(x[l], seeds[l], tuple(t[l] for t in dense),
                                        dims, rate)[0] for l in range(x.shape[0])]
    zs_p = [torch.stack([z[i] for z in per_lane]) for i in range(len(dims) - 1)]
    rows, count = relu_flip_rows(zs_k, zs_p)
    units = sum(z.numel() for z in zs_k)
    if count > max(2, units * FLIP_SHARE):
        raise ValueError(f"{count} of {units} ReLU units differ in sign: more than rounding "
                         f"at the edge explains")
    return (rows[0] if single else rows), count


def worst_errors(got, want):
    """(largest abs error, largest error as a share of its tensor's largest
    magnitude) over pairs of tensors; shapes must agree."""
    worst_abs = worst_rel = 0.0
    for a, b in zip(got, want):
        if a.shape != b.shape:
            raise ValueError(f"shapes differ: {tuple(a.shape)} vs {tuple(b.shape)}")
        err = float((a - b).abs().max())
        worst_abs = max(worst_abs, err)
        worst_rel = max(worst_rel, err / max(float(b.abs().max()), 1e-30))
    return worst_abs, worst_rel


def k1_vs_plain(kernel, plain, x, label, weight, seeds, dense, dims, rate, rel_tol):
    """Hold a K1 wrapper to its independent plain version on the card.

    Both run on the operands as given; if K1 and the plain version take some
    ReLU units differently (``k1_flip_rows``), both run again with those
    rows' weights set to 0 and that comparison decides. Raises unless every
    output is within ``rel_tol`` of its largest magnitude. Returns a dict:
    ``out`` the kernel's (loss, dx, grads) on the operands as given, ``err``
    the deciding comparison's largest abs error, ``flips`` the number of
    such units, ``rows`` the rows set aside, ``as_given`` the largest
    relative error with no row set aside.
    """
    flat = lambda r: [r[0], r[1], *r[2]]
    out = kernel(x, label, weight, seeds, dense, dims, rate)
    want = plain(x, label, weight, seeds, dense, dims, rate)
    err, rel = worst_errors(flat(out), flat(want))
    as_given = rel
    rows, flips = k1_flip_rows(x, label, weight, seeds, dense, dims, rate)
    if flips:
        w0 = torch.where(rows, 0.0, weight)
        err, rel = worst_errors(flat(kernel(x, label, w0, seeds, dense, dims, rate)),
                                flat(plain(x, label, w0, seeds, dense, dims, rate)))
    if not rel <= rel_tol:  # also catches a NaN
        raise ValueError(f"K1 differs from its plain version by {rel:.3e} of an output's "
                         f"largest magnitude (tolerance {rel_tol}; {flips} ReLU units on "
                         f"the edge in {int(rows.sum())} rows set aside)")
    return {"out": out, "err": err, "flips": flips, "rows": int(rows.sum()),
            "as_given": as_given}
