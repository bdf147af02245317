"""Streaming ROC-AUC with the reference's 500 thresholds, in plain PyTorch.

Counterpart of ``mamdr_tpu/metrics/auc.py``: the reference evaluates every
domain with a 500-threshold streaming AUC (reference utils/auc.py:16,
thresholds utils/auc.py:110-126, confusion semantics
utils/metrics_utils.py:194-214, interpolation summation utils/auc.py:249-281).
Published AUC numbers depend on this bucketing, so the math is the same:

  thresholds = [-eps] + [(i+1)/(T-1) for i in range(T-2)] + [1+eps]
  tp[t] = sum(w * (pred >  thr[t]) * (label == 1))  (fp/tn/fn analogous)
  recall = tp/(tp+fn); fpr = fp/(fp+tn)             (div_no_nan)
  auc = sum((fpr[:-1]-fpr[1:]) * (recall[:-1]+recall[1:])/2)

Thresholds are Python floats cast to float32 once, as the JAX package casts
them, so both compare against the same 500 values. With 0/1 weights every
partial count is an integer below 2**24, so the counts are exact in float32
whatever the summation order: given the same probabilities they equal the
JAX package's bit for bit.

Lane form: every argument may carry leading lane axes ([L, B] labels and
predictions, an [L, T] state); ``auc_result`` reduces the last axis, so an
[L, T] state gives [L] AUCs. Runs on whatever device its inputs are on.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

_K_EPSILON = 1e-7  # Keras backend epsilon (reference utils/auc.py:126)


class AucState(NamedTuple):
    true_positives: torch.Tensor   # [..., T]
    true_negatives: torch.Tensor   # [..., T]
    false_positives: torch.Tensor  # [..., T]
    false_negatives: torch.Tensor  # [..., T]


def auc_thresholds(num_thresholds: int = 500, thresholds: Optional[Sequence[float]] = None,
                   device=None) -> torch.Tensor:
    """Threshold vector with the -eps and 1+eps endpoints (utils/auc.py:110-126).

    ``thresholds``: explicit values in [0, 1]; when given they override
    ``num_thresholds`` (sorted, the two endpoints added).
    """
    if thresholds is not None:
        inner = sorted(float(t) for t in thresholds)
    else:
        if num_thresholds <= 1:
            raise ValueError("num_thresholds must be > 1")
        inner = [(i + 1) * 1.0 / (num_thresholds - 1) for i in range(num_thresholds - 2)]
    return torch.tensor([0.0 - _K_EPSILON] + inner + [1.0 + _K_EPSILON],
                        dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=None)
def _thresholds_on(device: torch.device, num_thresholds: int,
                   thresholds: Optional[Tuple[float, ...]]) -> torch.Tensor:
    """``auc_thresholds`` made once per device and kept: a tensor built
    from Python values on the card is a copy from pageable host memory,
    which would wait for the card on every update."""
    return auc_thresholds(num_thresholds, thresholds, device)


def auc_init(num_thresholds: int = 500, thresholds: Optional[Sequence[float]] = None,
             lanes: Sequence[int] = (), device=None) -> AucState:
    """Zero counts, [*lanes, T]."""
    n = (len(thresholds) + 2) if thresholds is not None else num_thresholds
    z = torch.zeros((*lanes, n), dtype=torch.float32, device=device)
    return AucState(z, z, z, z)


def auc_update(state: AucState, y_true: torch.Tensor, y_pred: torch.Tensor,
               weight: Optional[torch.Tensor] = None, num_thresholds: int = 500,
               thresholds: Optional[Sequence[float]] = None) -> AucState:
    """Add a batch's confusion counts to ``state``.

    ``y_true``, ``y_pred`` and ``weight`` (or None: weight 1) are [B], or
    [..., B] with the lane axes of ``state`` [..., T]. A prediction is
    positive when ``pred > threshold`` (strict; metrics_utils.py:203-207).
    The batch's counts are formed from zero and then added to the state.
    """
    thr = _thresholds_on(y_pred.device, num_thresholds,
                         None if thresholds is None else tuple(thresholds))
    y_true = y_true.to(torch.float32)
    y_pred = y_pred.to(torch.float32)
    w = torch.ones_like(y_pred) if weight is None else weight.to(torch.float32)

    label_pos = y_true > 0.5                              # [..., B]
    pred_pos = y_pred[..., None, :] > thr[:, None]        # [..., T, B]
    wp = torch.where(label_pos, w, 0.0)[..., None, :]     # positive-label rows' weights
    wn = torch.where(label_pos, 0.0, w)[..., None, :]

    tp = torch.sum(torch.where(pred_pos, wp, 0.0), dim=-1)
    fn = torch.sum(torch.where(pred_pos, 0.0, wp), dim=-1)
    fp = torch.sum(torch.where(pred_pos, wn, 0.0), dim=-1)
    tn = torch.sum(torch.where(pred_pos, 0.0, wn), dim=-1)
    return AucState(state.true_positives + tp, state.true_negatives + tn,
                    state.false_positives + fp, state.false_negatives + fn)


def _div_no_nan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(b == 0.0, 0.0, a / torch.where(b == 0.0, 1.0, b))


def interpolate_pr_auc(state: AucState) -> torch.Tensor:
    """PR-AUC by the Davis & Goadrich 2006 interpolation (utils/auc.py:179-246):
    TP and P = TP + FP vary linearly within each threshold interval."""
    tp, fp, fn = state.true_positives, state.false_positives, state.false_negatives
    dtp = tp[..., :-1] - tp[..., 1:]
    p = tp + fp
    dp = p[..., :-1] - p[..., 1:]
    prec_slope = _div_no_nan(dtp, torch.clamp(dp, min=0.0))
    intercept = tp[..., 1:] - prec_slope * p[..., 1:]
    safe_p_ratio = torch.where(
        (p[..., :-1] > 0) & (p[..., 1:] > 0),
        _div_no_nan(p[..., :-1], torch.clamp(p[..., 1:], min=0.0)),
        torch.ones_like(p[..., 1:]),
    )
    return torch.sum(_div_no_nan(prec_slope * (dtp + intercept * torch.log(safe_p_ratio)),
                                 torch.clamp(tp[..., 1:] + fn[..., 1:], min=0.0)), dim=-1)


def auc_result(state: AucState, curve: str = "ROC",
               summation_method: str = "interpolation") -> torch.Tensor:
    """AUC by Riemann summation (utils/auc.py:248-281), over the last axis.

    curve: 'ROC' (x = FPR, y = recall) or 'PR' (x = recall, y = precision).
    summation_method: 'interpolation' (midpoint; for PR the Davis & Goadrich
    form), 'minoring' (the lower of each interval's endpoints), 'majoring'
    (the higher).
    """
    curve = curve.upper()
    summation_method = summation_method.lower()
    if curve not in ("ROC", "PR"):
        raise ValueError(f"invalid curve {curve!r}; options: ROC, PR")
    if summation_method not in ("interpolation", "minoring", "majoring"):
        raise ValueError(f"invalid summation method {summation_method!r}; "
                         "options: interpolation, minoring, majoring")
    if curve == "PR" and summation_method == "interpolation":
        return interpolate_pr_auc(state)
    recall = _div_no_nan(state.true_positives,
                         state.true_positives + state.false_negatives)
    if curve == "ROC":
        x = _div_no_nan(state.false_positives,
                        state.false_positives + state.true_negatives)
        y = recall
    else:
        x = recall
        y = _div_no_nan(state.true_positives, state.true_positives + state.false_positives)
    if summation_method == "interpolation":
        heights = (y[..., :-1] + y[..., 1:]) / 2.0
    elif summation_method == "minoring":
        heights = torch.minimum(y[..., :-1], y[..., 1:])
    else:
        heights = torch.maximum(y[..., :-1], y[..., 1:])
    return torch.sum((x[..., :-1] - x[..., 1:]) * heights, dim=-1)
