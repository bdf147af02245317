"""The port's streaming AUC (mamdr_tpu_torch/metrics/auc.py) vs the JAX package's.

- thresholds: bit-equal, the default 500 and other counts, and explicit ones;
- ``auc_update``: the confusion counts bit-exact on the same probabilities,
  labels and 0/1 weights (no weights, partial and all-pad batches, several
  batches accumulated, the lane form against the JAX update lane by lane);
- ``auc_result``: all six curve / summation pairs within abs 1e-6 on the same
  counts (float32 sums over 499 intervals taken in another order);
- invalid arguments raise as in the JAX package.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamdr_tpu.metrics import auc as jauc
from mamdr_tpu_torch.metrics import auc as tauc

CURVES = [("ROC", "interpolation"), ("ROC", "minoring"), ("ROC", "majoring"),
          ("PR", "interpolation"), ("PR", "minoring"), ("PR", "majoring")]


def _batches(seed, n_batches, batch, weights, lanes=None):
    rng = np.random.default_rng(seed)
    shape = (n_batches, batch) if lanes is None else (n_batches, lanes, batch)
    probs = rng.uniform(0, 1, shape).astype(np.float32)
    # the ends of the threshold range, and values equal to thresholds (strict >)
    edges = np.asarray([0.0, 1.0, 0.5, *np.asarray(jauc.auc_thresholds(500))[[1, 10, 250]]],
                       np.float32)
    k = min(batch, edges.size)
    probs[..., :k] = edges[:k]
    labels = (rng.uniform(0, 1, shape) < 0.4).astype(np.float32)
    if weights == "none":
        w = None
    else:
        w = (rng.uniform(0, 1, shape) > 0.3).astype(np.float32)
        if weights == "all_pad":
            w[-1] = 0.0  # the last batch (of every lane) holds no data
    return probs, labels, w


def _jax_counts(probs, labels, w, num_thresholds=500, thresholds=None):
    state = jauc.auc_init(num_thresholds, thresholds)
    for i in range(probs.shape[0]):
        state = jauc.auc_update(state, jnp.asarray(labels[i]), jnp.asarray(probs[i]),
                                None if w is None else jnp.asarray(w[i]),
                                num_thresholds, thresholds)
    return state


def _port_counts(probs, labels, w, num_thresholds=500, thresholds=None, lanes=()):
    state = tauc.auc_init(num_thresholds, thresholds, lanes=lanes)
    for i in range(probs.shape[0]):
        state = tauc.auc_update(state, torch.from_numpy(labels[i]), torch.from_numpy(probs[i]),
                                None if w is None else torch.from_numpy(w[i]),
                                num_thresholds, thresholds)
    return state


def _equal_counts(port, jax_state):
    for name, a, b in zip(tauc.AucState._fields, port, jax_state):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


@pytest.mark.parametrize("num_thresholds", [2, 3, 7, 200, 500])
def test_thresholds_bit_equal(num_thresholds):
    got = tauc.auc_thresholds(num_thresholds).numpy()
    want = np.asarray(jauc.auc_thresholds(num_thresholds))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert got[0] < 0.0 < 1.0 < got[-1]


def test_explicit_thresholds_bit_equal():
    thr = [0.9, 0.1, 0.5, 0.25]
    np.testing.assert_array_equal(tauc.auc_thresholds(thresholds=thr).numpy(),
                                  np.asarray(jauc.auc_thresholds(thresholds=thr)))
    assert tauc.auc_init(thresholds=thr).true_positives.shape == (6,)


@pytest.mark.parametrize("weights", ["none", "binary", "all_pad"])
@pytest.mark.parametrize("n_batches,batch", [(1, 1), (1, 1024), (5, 37)])
def test_update_counts_bit_exact(weights, n_batches, batch):
    probs, labels, w = _batches(1, n_batches, batch, weights)
    _equal_counts(_port_counts(probs, labels, w), _jax_counts(probs, labels, w))


def test_update_counts_bit_exact_with_explicit_thresholds():
    thr = [0.05, 0.3, 0.31, 0.8]
    probs, labels, w = _batches(2, 3, 64, "binary")
    _equal_counts(_port_counts(probs, labels, w, thresholds=thr),
                  _jax_counts(probs, labels, w, thresholds=thr))


@pytest.mark.parametrize("weights", ["binary", "all_pad"])
def test_update_lane_form_bit_exact(weights):
    """[L, B] batches into an [L, T] state == the JAX update of each lane."""
    lanes = 4
    probs, labels, w = _batches(3, 3, 50, weights, lanes=lanes)
    port = _port_counts(probs, labels, w, lanes=(lanes,))
    for l in range(lanes):
        want = _jax_counts(probs[:, l], labels[:, l], w[:, l])
        _equal_counts(tauc.AucState(*(x[l] for x in port)), want)
    if weights == "all_pad":  # the all-pad batch added exact zeros
        before = _port_counts(probs[:-1], labels[:-1], w[:-1], lanes=(lanes,))
        _equal_counts(port, tuple(x.numpy() for x in before))


@pytest.mark.parametrize("curve,summation", CURVES)
@pytest.mark.parametrize("seed", [4, 5])
def test_result_all_curves(curve, summation, seed):
    probs, labels, w = _batches(seed, 4, 128, "binary")
    port = tauc.auc_result(_port_counts(probs, labels, w), curve, summation)
    want = jauc.auc_result(_jax_counts(probs, labels, w), curve, summation)
    assert abs(float(port) - float(want)) <= 1e-6
    # the lane form: one AUC a lane
    stacked = tauc.AucState(*(torch.stack([x, x + 1.0]) for x in _port_counts(probs, labels, w)))
    lanes = tauc.auc_result(stacked, curve, summation)
    assert lanes.shape == (2,) and float(lanes[0]) == float(port)


def test_result_of_empty_and_one_class_counts_matches():
    """No data, or one label only: the div_no_nan branches."""
    for labels_value in (0.0, 1.0):
        probs = np.full((1, 8), 0.7, np.float32)
        labels = np.full((1, 8), labels_value, np.float32)
        w = np.ones((1, 8), np.float32)
        for curve, summation in CURVES:
            got = float(tauc.auc_result(_port_counts(probs, labels, w), curve, summation))
            want = float(jauc.auc_result(_jax_counts(probs, labels, w), curve, summation))
            assert abs(got - want) <= 1e-6, (labels_value, curve, summation)
    assert float(tauc.auc_result(tauc.auc_init())) == 0.0


def test_invalid_arguments_raise():
    state = tauc.auc_init()
    with pytest.raises(ValueError, match="curve"):
        tauc.auc_result(state, curve="XYZ")
    with pytest.raises(ValueError, match="summation"):
        tauc.auc_result(state, summation_method="trapezoid")
    with pytest.raises(ValueError, match="num_thresholds"):
        tauc.auc_thresholds(1)
