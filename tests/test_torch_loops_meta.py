"""The per-call loops of the meta strategies in the port vs the JAX
package's, on the CPU, by the recipe of tests/test_torch_loops.py
(``loop_pair``: 3 domains of about 200 train rows, batch 64, hidden [16, 8],
dropout off, the same start, the shuffle ON, 2 epochs):

- ``_train_loop`` of Domain Negotiation, Reptile (per-domain and batch),
  MAML, MLDG and PCGrad (modes "reference" and "paper"), each with a target
  domain, which sends them to the loop: params, Adam slots, the best
  params, the meta-Adam's moments (MAML family), the early stop's state
  (on the target domain's val AUC) and ``np_rng``'s state, rtol 2e-5 /
  atol 1e-5;
- ``meta_finetune_val`` by the sequential route (``fit_domain`` /
  ``evaluate_domain``, the shuffle on) and by the lane route at one batch
  a domain (where the lanes' shuffle cannot matter): per-domain val loss
  rtol 2e-5, AUC abs 1e-5; neither route changes ``t.state``;
- ``average_meta_grad`` "drop", whose masks are the port's hash masks from
  its own seeds (jax.random's stream cannot be reproduced), by its
  properties: leaves of rank 2 or more untouched, 1-D entries 0 or g/0.8, a
  kept share of about 0.8, the same seed the same masks; and MAML's routing
  of it to ``accumulate_split``.
"""

import numpy as np
import pytest
import torch

from mamdr_tpu_torch.strategies.meta_base import MetaStrategy
from mamdr_tpu_torch.train import fused
from mamdr_tpu_torch.utils import trees
from test_torch_loops import loop_pair, states_close
from test_torch_meta_strategies import _meta_adam_close

MAML_SPLIT = {"meta_split": "meta-train/val", "meta_split_ratio": 0.5}

META_LOOPS = {
    "dn": ("mlp_meta_domain_negotiation_finetune", {"meta_train_step": 2}),
    "reptile": ("mlp_meta_reptile_finetune", {"meta_train_step": 3}),
    "reptile_batch": ("mlp_meta_reptile_batch_finetune", {}),
    "maml": ("mlp_meta_maml_finetune", {**MAML_SPLIT, "meta_train_step": 2,
                                        "average_meta_grad": "mean"}),
    "mldg": ("mlp_meta_mldg_finetune", {**MAML_SPLIT, "average_meta_grad": "moving_mean"}),
    "pcgrad": ("mlp_pcgrad", {"meta_train_step": 2}),
    "pcgrad_paper": ("mlp_pcgrad", {**MAML_SPLIT, "pcgrad_mode": "paper"}),
}


@pytest.mark.parametrize("variant", list(META_LOOPS))
def test_meta_loop_with_target_matches_jax(tmp_path, variant):
    """Two epochs of the strategy's _train_loop with target domain 1."""
    name, train = META_LOOPS[variant]
    jt, js, tt, ts = loop_pair(tmp_path, name, target_domain=1, meta_learning_rate=0.05,
                               **train)
    assert ts.target_domain == js.target_domain == 1
    js.train()
    ts.train()
    states_close(jt, tt)
    if hasattr(js, "meta_opt_state"):
        _meta_adam_close(ts.meta_opt_state, js.meta_opt_state, ts.mask)
        assert int(ts.meta_opt_state.count) > 0


def _same_state(before, after):
    for a, b in zip(trees.leaves(before.params), trees.leaves(after.params)):
        assert a is b
    assert before.opt_state is after.opt_state and before.step is after.step


@pytest.mark.parametrize("route", ["sequential", "lanes"])
def test_meta_finetune_val_matches_jax(tmp_path, monkeypatch, route):
    """meta_finetune_step 2 from the state after a DN epoch (live Adam slots,
    step 12 or 3): the sequential route through fit_domain with the shuffle
    on (about 200 rows a domain, 4 batches), or the lanes at one batch a
    domain; t.state untouched."""
    lanes = route == "lanes"
    jt, js, tt, ts = loop_pair(tmp_path, "mlp_meta_domain_negotiation_finetune",
                               n_per_domain=100 if lanes else 330, meta_finetune_step=2,
                               epoch=1)
    if not lanes:
        for t in (jt, tt):
            monkeypatch.setattr(t, "fused_padding_ok", lambda ragged=False: False)
    js.train()
    ts.train()  # DN, then epoch_tail's validation: meta_finetune_val by the route
    assert max(tt.steps_per_domain()) == (1 if lanes else 4)
    states_close(jt, tt)
    before = tt.state
    jres, tres = js.meta_finetune_val(), ts.meta_finetune_val()
    _same_state(before, tt.state)
    _, _, jdl, jda = jres
    _, _, tdl, tda = tres
    np.testing.assert_allclose([tdl[k] for k in jdl], [jdl[k] for k in jdl], rtol=2e-5)
    np.testing.assert_allclose([tda[k] for k in jda], [jda[k] for k in jda], rtol=0, atol=1e-5)
    assert tt.np_rng.bit_generator.state == jt.np_rng.bit_generator.state


def test_drop_accumulate_properties():
    """fused.accumulate_grads in "drop" mode: 1-D leaves dropped elementwise
    with keep 0.8 and scaled by 1/0.8, rank-2 leaves and leaves outside the
    accumulator untouched; the kept share over 200k draws within 0.005 of
    0.8; two 1-D leaves get masks of their own; the same seed gives the same
    masks, another seed others; no seed, no drop."""
    g = {"b": torch.linspace(0.1, 1.0, 100_000), "c": torch.linspace(0.1, 1.0, 100_000),
         "k": torch.randn(40, 5), "x": torch.ones(7)}
    mask = {"b": True, "c": True, "k": True, "x": False}
    acc = fused.zeros_acc(mask, g)
    one = fused.accumulate_grads(acc, g, mask, "drop", 11)
    assert one["x"] is None
    assert torch.equal(one["k"], g["k"])
    kept = one["b"] != 0.0
    assert torch.equal(one["b"][kept], g["b"][kept] / 0.8)
    assert not torch.equal(kept, one["c"] != 0.0)
    two = fused.accumulate_grads(acc, g, mask, "drop", 12)
    share = (float(kept.float().mean()) + float((two["b"] != 0).float().mean())) / 2
    assert abs(share - 0.8) < 0.005
    assert not torch.equal(one["b"], two["b"])
    again = fused.accumulate_grads(acc, g, mask, "drop", 11)
    assert torch.equal(again["b"], one["b"])
    summed = fused.accumulate_grads(one, g, mask, "sum")
    assert torch.equal(summed["k"], 2 * g["k"])
    with pytest.raises(ValueError, match="drop_seed"):
        fused.accumulate_grads(acc, g, mask, "drop")


def test_drop_routes_through_accumulate_split(tmp_path, monkeypatch):
    """MAML with average_meta_grad "drop" takes the loop, and its gradients
    go through accumulate_split in mode "drop": on a one-batch split the
    kernels' gradients are the plain sum's, each bias entry 0 or the sum's
    divided by 0.8, some of them 0."""
    _, _, tt, ts = loop_pair(tmp_path, "mlp_meta_maml_finetune", average_meta_grad="drop")
    assert isinstance(ts, MetaStrategy) and ts._accumulate() == "drop"
    modes = []
    grad_epoch = fused.grad_epoch
    monkeypatch.setattr(fused, "grad_epoch",
                        lambda *a, **k: modes.append(a[5]) or grad_epoch(*a, **k))
    split = tt.dataset.train[0].take(np.arange(64))
    params = tt.state.params
    dropped = ts.accumulate_split(params, split, fused.zeros_acc(ts.mask, params))
    summed = grad_epoch(tt.accum_grad_fn, params, tt.stack_split(split, shuffle=False),
                        fused.zeros_acc(ts.mask, params), ts.mask, "sum")
    assert modes == ["drop"]
    zeros = 0
    for (n, d), s in zip(trees.leaves_with_names(dropped), trees.leaves(summed)):
        if d is None:
            continue
        if d.dim() == 1:
            kept = d != 0.0
            zeros += int((~kept).sum())
            np.testing.assert_allclose(d[kept].numpy(), (s[kept] / 0.8).numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=n)
        else:
            np.testing.assert_allclose(d.numpy(), s.numpy(), rtol=1e-5, atol=1e-7, err_msg=n)
    assert zeros > 0
    tt.config.train.epoch = 1
    monkeypatch.setattr(ts, "_train_fused", lambda: pytest.fail("drop took the fused epoch"))
    ts.train()
    assert len(modes) > 1 and set(modes) == {"drop"}
