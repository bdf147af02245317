"""The port's finetune stage and separate training (strategies/separate.py) vs
the JAX package's.

Both sides start from the same parameters, specific and best weights
(tests/test_torch_eval.py ``make_pair``), dropout off:

- MAMDR's finetune (``separate_train_val_test(init_params=False)`` from each
  domain's merged best weights, SGD lanes) over 4 epochs with patience 2,
  frozen and trainable tables, balanced and long-tailed data. The JAX
  package's finetune lanes always shuffle with its own PRNG, so here every
  domain has at most ``batch_size`` train rows: its one batch is the same set
  of rows on both sides, summed in another order;
- the bucketed route (long-tailed step counts, two buckets) and Adam lanes
  from the same start (``init_params=True``), several batches a domain: here
  both packages' ``_epoch_on_flat`` run with ``shuffle=False`` (patched in for
  the test), so the batches are the same;
- ``step_buckets`` against the JAX one, and the route each padding takes.

Tolerances: per-domain test loss rtol 2e-5, AUC abs 1e-6 (equal counts from
probabilities equal to ~1e-7), and each domain's checkpointed best weights
rtol 2e-5 / atol 1e-6 (SGD is linear in the gradient); the Adam lanes' losses
rtol 1e-4 (Adam turns last-bit gradient differences of near-zero elements
into steps of order lr, as the DR tests found).
"""

import functools
import os

import numpy as np
import pytest

from mamdr_tpu.strategies import separate as jseparate
from mamdr_tpu.train import fused as jfused
from mamdr_tpu_torch.strategies import separate
from mamdr_tpu_torch.train import fused
from test_torch_eval import make_pair


def _results_close(tres, jres, loss_rtol=2e-5, auc_atol=1e-6):
    _, _, tdl, tda = tres
    _, _, jdl, jda = jres
    assert sorted(tdl) == sorted(jdl)
    np.testing.assert_allclose([tdl[k] for k in jdl], [jdl[k] for k in jdl], rtol=loss_rtol)
    np.testing.assert_allclose([tda[k] for k in jda], [jda[k] for k in jda], rtol=0,
                               atol=auc_atol)
    assert all(0.0 <= v <= 1.0 for v in tda.values())


def _domain_checkpoints_close(tt, jt, n_domain):
    for d in range(n_domain):
        with np.load(os.path.join(tt.checkpoint_dir, f"domain_{d}.npz")) as t, \
                np.load(os.path.join(jt.checkpoint_dir, f"domain_{d}.npz")) as j:
            assert sorted(t.files) == sorted(j.files)
            for k in j.files:
                np.testing.assert_allclose(t[k], j[k], rtol=2e-5, atol=1e-6, err_msg=k)


def _no_shuffle(monkeypatch):
    monkeypatch.setattr(jfused, "_epoch_on_flat",
                        functools.partial(jfused._epoch_on_flat, shuffle=False))
    monkeypatch.setattr(fused, "_epoch_on_flat",
                        functools.partial(fused._epoch_on_flat, shuffle=False))


@pytest.mark.parametrize("emb_trainable", [False, True])
@pytest.mark.parametrize("long_tail", [False, True])
def test_mamdr_finetune_matches_jax(tmp_path, long_tail, emb_trainable):
    jt, js, tt, ts = make_pair(tmp_path, long_tail, emb_trainable, n_per_domain=100,
                               batch=64, epoch=4)
    assert max(tt.steps_per_domain()) == 1  # one batch a domain: shuffles only permute it
    params0 = [ts._best_params_fn(d) for d in range(3)]
    jres, tres = js.finetune(), ts.finetune()
    _results_close(tres, jres)
    _domain_checkpoints_close(tt, jt, 3)
    # the finetuned weights moved off their start, every domain its own
    for d in range(3):
        with np.load(os.path.join(tt.checkpoint_dir, f"domain_{d}.npz")) as z:
            kernel = z["model//dnn//Dense_0//Dense_0//kernel"]
        start = params0[d]["model"]["dnn"]["Dense_0"]["Dense_0"]["kernel"].numpy()
        assert not np.array_equal(kernel, start)


def test_finetune_bucketed_route_matches_jax(tmp_path, monkeypatch):
    _no_shuffle(monkeypatch)
    jt, js, tt, ts = make_pair(tmp_path, long_tail=True, n_domain=4, batch=16, epoch=3)
    steps = tt.steps_per_domain()
    assert len(separate.step_buckets(steps)) == 2, steps
    jres = jseparate._separate_bucketed(jt, False, js._best_params_fn, None)
    tres = separate._separate_bucketed(tt, False, ts._best_params_fn)
    _results_close(tres, jres)
    _domain_checkpoints_close(tt, jt, 4)


@pytest.mark.parametrize("emb_trainable", [False, True])
def test_separate_adam_lanes_match_jax(tmp_path, monkeypatch, emb_trainable):
    """init_params=True: every domain from the trainer's weights, fresh Adam
    slots per lane (the separate strategy's lanes)."""
    _no_shuffle(monkeypatch)
    jt, js, tt, ts = make_pair(tmp_path, emb_trainable=emb_trainable, n_per_domain=150,
                               batch=32, epoch=3)
    assert min(tt.steps_per_domain()) > 1
    jres = jseparate.separate_train_val_test(jt, init_params=True)
    tres = separate.separate_train_val_test(tt, init_params=True)
    _results_close(tres, jres, loss_rtol=1e-4)


@pytest.mark.parametrize("steps", [[12, 8, 5, 4], [1], [3, 3, 3], [10, 1, 5, 2, 20, 9],
                                   [4, 9, 2, 2, 17]])
def test_step_buckets_match_jax(steps):
    assert separate.step_buckets(steps) == jseparate.step_buckets(steps)


def test_routes(tmp_path, monkeypatch):
    """Balanced padding: all domains as lanes at once; padding past the
    break-even: buckets; past the memory budget, or separate_fused false:
    the sequential loop."""
    _, _, tt, _ = make_pair(tmp_path)
    taken = []
    for route in ("fused", "bucketed", "loop"):
        monkeypatch.setattr(separate, f"_separate_{route}",
                            lambda *a, route=route, **k: taken.append(route))
    separate.separate_train_val_test(tt)
    monkeypatch.setattr(tt, "fused_padding_ok", lambda ragged=False: ragged)
    separate.separate_train_val_test(tt)
    monkeypatch.setattr(tt, "fused_padding_ok", lambda ragged=False: False)
    separate.separate_train_val_test(tt)
    monkeypatch.setattr(tt, "fused_padding_ok", lambda ragged=False: True)
    tt.config.train.separate_fused = False
    separate.separate_train_val_test(tt)
    assert taken == ["fused", "bucketed", "loop", "loop"]
