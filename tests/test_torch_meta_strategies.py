"""The port's MAML, MLDG, PCGrad and uncertainty-weighted joint strategies
vs the JAX package's, on the CPU.

- one epoch of ``fused.make_fused_maml`` (MAML and MLDG, per-domain and
  batch, step cap 0 and 2, "sum" and "ema" accumulation) and of
  ``fused.make_fused_pcgrad`` (modes "reference" and "paper", cap 0 and 2)
  from the same state against the JAX functions with ``shuffle=False``,
  several batches a domain on a long-tailed block, support and query of
  different lengths: params, meta and the inner and meta-Adam moments
  within rtol 2e-5 / atol 1e-5, the step counts equal; frozen tables and
  meta's unmasked leaves come out as the same tensors;
- a whole ``run()`` of ``mlp_meta_maml_finetune``,
  ``mlp_meta_mldg_finetune``, ``mlp_pcgrad``, ``mlp_uncertainty_weight`` and
  ``mlp_meta_maml_batch_finetune`` (the corpus's meta_split and ratio),
  balanced with trainable tables and long-tailed with frozen ones, at most
  one batch a split (the JAX package shuffles rows with its own PRNG): per
  domain test loss within rtol 1e-4, AUC within abs 1e-5; the early stop's
  state, ``np_rng``'s state and the ``metrics.jsonl`` events equal;
- ``build_strategy``'s routing of the four names.
"""

import jax
import numpy as np
import pytest
import torch

from mamdr_tpu.data.dataset import split_support_query as jsplit_support_query
from mamdr_tpu.train import fused as jfused
from mamdr_tpu_torch.convert import meta_adam_state_from_jax
from mamdr_tpu_torch.data.dataset import split_support_query
from mamdr_tpu_torch.strategies.joint import JointStrategy
from mamdr_tpu_torch.strategies.maml import MAMLStrategy
from mamdr_tpu_torch.strategies.mldg import MLDGStrategy
from mamdr_tpu_torch.strategies.pcgrad import PCGradStrategy
from mamdr_tpu_torch.train import fused
from mamdr_tpu_torch.utils import trees
from test_torch_strategies import _trees_close, events, make_strategy_pair, results_close

META = {"meta_learning_rate": 1e-2}
MAML_SPLIT = {"meta_split": "meta-train/val", "meta_split_ratio": 0.2}
MLDG_SPLIT = {"meta_split": "meta-train/val", "meta_split_ratio": 0.8}


def _adam_state(opt_state):
    """optax.adam's ScaleByAdamState inside the JAX meta-optimizer's chain."""
    for leaf in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(leaf, "mu"):
            return leaf
    raise AssertionError("no adam state")


def _meta_adam_close(tstate, jstate, mask):
    j = _adam_state(jstate)
    want = meta_adam_state_from_jax(j.count, jax.device_get(j.mu), jax.device_get(j.nu), mask)
    assert int(tstate.count) == int(want.count)
    np.testing.assert_allclose(tstate.mu.numpy(), want.mu.numpy(), rtol=2e-5, atol=1e-8)
    np.testing.assert_allclose(tstate.nu.numpy(), want.nu.numpy(), rtol=2e-5, atol=1e-12)


def _frozen_same(ttree, reference, emb_trainable, mask=None):
    """Frozen tables (and meta's unmasked leaves) are the same tensors."""
    mask_of = dict(trees.leaves_with_names(mask)) if mask is not None else {}
    for (n, a), b in zip(trees.leaves_with_names(ttree), trees.leaves(reference)):
        frozen = not emb_trainable and ("user_emb" in n or "item_emb" in n)
        if not mask_of.get(n, True) or frozen:
            assert a is b, n


def _splits(jt, tt, mode, ratio):
    jrng, trng = np.random.default_rng(11), np.random.default_rng(11)
    js = [jsplit_support_query(s, mode, ratio, jrng) for s in jt.dataset.train]
    ts = [split_support_query(s, mode, ratio, trng) for s in tt.dataset.train]
    return js, ts


MAML_EPOCHS = [  # (mldg, batch_mode, cap, accumulate)
    (False, False, 0, "sum"), (False, False, 2, "sum"), (False, True, 0, "ema"),
    (False, True, 2, "sum"), (True, False, 0, "sum"), (True, False, 2, "ema"),
    (True, True, 0, "sum"), (True, True, 2, "sum")]


@pytest.mark.parametrize("emb_trainable", [False, True])
@pytest.mark.parametrize("mldg,batch_mode,cap,accumulate", MAML_EPOCHS)
def test_fused_maml_epoch_matches_jax(tmp_path, mldg, batch_mode, cap, accumulate,
                                      emb_trainable):
    """Support 60% and query 40% of each long-tailed domain (3, 2, 1 and 2,
    2, 1 batches of 32): one epoch from the same state, shuffle off;
    grad_scale as "mean" gives it when capped."""
    name = "mlp_meta_mldg" if mldg else "mlp_meta_maml"
    if batch_mode:
        name += "_batch"
    batch = 32
    jt, js, tt, ts = make_strategy_pair(tmp_path, name, True, emb_trainable, n_per_domain=200,
                                        batch=batch, epoch=1, **META)
    assert type(ts) is (MLDGStrategy if mldg else MAMLStrategy)
    jsq, tsq = _splits(jt, tt, "meta-train/val", 0.6)
    jsup, jn_s = jfused.stack_domains_on_device([s for s, _ in jsq], batch)
    jq, jn_q = jfused.stack_domains_on_device([q for _, q in jsq], batch)
    tsup, tn_s = fused.stack_domains_on_device([s for s, _ in tsq], batch, "cpu")
    tq, tn_q = fused.stack_domains_on_device([q for _, q in tsq], batch, "cpu")
    sup_steps = fused.domain_step_counts([s for s, _ in tsq], batch)
    q_steps = fused.domain_step_counts([q for _, q in tsq], batch)
    assert (tn_s, tn_q) == (jn_s, jn_q) and sup_steps != q_steps
    assert len(set(sup_steps)) > 1 and max(sup_steps) > 1
    order = np.asarray([2, 0, 1], np.int32)
    scale = 1.0 / (3 * cap) if cap else 1.0
    kw = dict(batch_mode=batch_mode, cap_steps=cap, accumulate=accumulate, mldg=mldg,
              shuffle=False, steps_list_support=sup_steps, steps_list_query=q_steps)
    jfn = jfused.make_fused_maml(jt.train_step_fn(), jt.accum_grad_fn, js.mask, js.meta_tx,
                                 jn_s, jn_q, batch, **kw)
    tfn = fused.make_fused_maml(tt.train_step_fn(), tt.accum_grad_fn, ts.mask, ts.meta_tx,
                                tn_s, tn_q, batch, **kw)
    jstate, jmeta, jopt = jfn(jt.state, jt.state.params, js.meta_opt_state, jsup, jq, order,
                              jax.random.PRNGKey(0), scale)
    params0 = tt.state.params
    tstate, tmeta, topt = tfn(tt.state, params0, ts.meta_opt_state, tsup, tq, order, tt.gen,
                              scale)
    inner = 0 if mldg else sum(min(s, cap) if cap else s for s in sup_steps)
    assert int(tstate.step) == int(jstate.step) == inner
    applies = (1 if batch_mode else 3) + (3 if mldg else 0)
    assert int(topt.count) == applies
    _trees_close(tstate.params, jstate.params, "params")
    _trees_close(tmeta, jmeta, "meta")
    _meta_adam_close(topt, jopt, ts.mask)
    np.testing.assert_allclose(tstate.opt_state.mu.numpy(), np.asarray(jstate.opt_state.mu),
                               rtol=2e-5, atol=1e-8)
    _frozen_same(tmeta, params0, emb_trainable, ts.mask)
    _frozen_same(tstate.params, params0, emb_trainable)
    for (n, m), a, b in zip(trees.leaves_with_names(ts.mask), trees.leaves(tmeta),
                            trees.leaves(params0)):
        assert not m or not torch.equal(a, b), n  # every masked leaf moved


PCGRAD_EPOCHS = [("reference", 0), ("reference", 2), ("paper", 0), ("paper", 2)]


@pytest.mark.parametrize("emb_trainable", [False, True])
@pytest.mark.parametrize("mode,cap", PCGRAD_EPOCHS)
def test_fused_pcgrad_epoch_matches_jax(tmp_path, mode, cap, emb_trainable):
    """One epoch over the long-tailed train block (4, 3, 2 batches), two aux
    domains a query, shuffle off."""
    batch = 32
    jt, js, tt, ts = make_strategy_pair(tmp_path, "mlp_pcgrad", True, emb_trainable,
                                        n_per_domain=200, batch=batch, epoch=1,
                                        pcgrad_mode=mode, **META)
    assert type(ts) is PCGradStrategy
    jblock, n_steps = jt.train_block()
    tblock, _ = tt.train_block()
    steps = tt.steps_per_domain()
    assert steps == [4, 3, 2]
    order = np.asarray([2, 0, 1], np.int32)
    aux = np.asarray([[0, 1], [1, 2], [2, 0]], np.int32)
    scale = 1.0 / (3 * cap) if cap else 1.0
    jfn = jfused.make_fused_pcgrad(jt.accum_grad_fn, js.mask, js.meta_tx, n_steps, batch,
                                   cap_steps=cap, mode=mode, shuffle=False, steps_list=steps)
    tfn = fused.make_fused_pcgrad(tt.accum_grad_fn, ts.mask, ts.meta_tx, n_steps, batch,
                                  cap_steps=cap, mode=mode, shuffle=False, steps_list=steps)
    jstate, jopt = jfn(jt.state, js.meta_opt_state, jblock, order, aux,
                       jax.random.PRNGKey(0), scale)
    params0 = tt.state.params
    tstate, topt = tfn(tt.state, ts.meta_opt_state, tblock, order, aux, tt.gen, scale)
    assert int(tstate.step) == int(jstate.step) == 0  # the model's optimizer is not used
    assert tstate.opt_state is tt.state.opt_state
    assert int(topt.count) == 3
    _trees_close(tstate.params, jstate.params, "params")
    _meta_adam_close(topt, jopt, ts.mask)
    _frozen_same(tstate.params, params0, emb_trainable)


RUNS = [
    ("mlp_meta_maml_finetune", MAMLStrategy, MAML_SPLIT),
    ("mlp_meta_mldg_finetune", MLDGStrategy, MLDG_SPLIT),
    ("mlp_pcgrad", PCGradStrategy, {"sample_num": 2}),
    ("mlp_uncertainty_weight", JointStrategy, {}),
    ("mlp_meta_maml_batch_finetune", MAMLStrategy,
     {**MAML_SPLIT, "average_meta_grad": "moving_mean"}),
]


@pytest.mark.parametrize("long_tail,emb_trainable", [(True, False), (False, True)])
@pytest.mark.parametrize("name,cls,train", RUNS)
def test_run_matches_jax(tmp_path, name, cls, train, long_tail, emb_trainable):
    jt, js, tt, ts = make_strategy_pair(tmp_path, name, long_tail, emb_trainable,
                                        **META, **train)
    assert type(ts) is cls and max(tt.steps_per_domain()) == 1
    params0 = tt.state.params
    jres, tres = js.run(), ts.run()
    results_close(tres, jres)
    assert tt.stopper.best_metric == pytest.approx(jt.stopper.best_metric, abs=1e-5)
    assert (tt.stopper.counter, tt.stopper.early_stop) == (jt.stopper.counter,
                                                           jt.stopper.early_stop)
    assert tt.np_rng.bit_generator.state == jt.np_rng.bit_generator.state
    assert events(tt) == events(jt)
    assert events(tt).count("val_eval") >= 2
    best = tt.best_params if tt.best_params is not None else tt.state.params
    _trees_close(best, jax.device_get(jt.best_params if jt.best_params is not None
                                      else jt.state.params), "best params")
    _frozen_same(best, params0, emb_trainable)
    if name == "mlp_uncertainty_weight":
        lv = best["uncertainty"]["log_vars"]
        assert not torch.equal(lv, params0["uncertainty"]["log_vars"])
    if isinstance(ts, MAMLStrategy) and not isinstance(ts, PCGradStrategy):
        # meta moved only on its masked leaves; frozen tables the same tensors
        for (n, m), a, b in zip(trees.leaves_with_names(ts.mask), trees.leaves(ts.meta),
                                trees.leaves(params0)):
            assert m != torch.equal(a, b), n
            if not m:
                assert a is b, n


def test_build_strategy_routes_the_meta_names(tmp_path):
    for name, cls in (("mlp_pcgrad", PCGradStrategy), ("mlp_meta_maml", MAMLStrategy),
                      ("mlp_meta_mldg_batch", MLDGStrategy),
                      ("mlp_uncertainty_weight", JointStrategy)):
        _, _, tt, ts = make_strategy_pair(tmp_path / name, name, **META)
        assert type(ts) is cls
        assert ("uncertainty" in tt.state.params) == (name == "mlp_uncertainty_weight")
