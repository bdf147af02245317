"""The port's lane-batched evaluation vs the JAX package's fused evals.

Both packages start from the same parameters (``convert.params_from_jax``)
and the same specific weights (``convert.specific_from_jax``), on the same
synthetic data:

- MAMDR's merged eval (``fused.make_fused_eval_merged``, every domain a lane
  with its merged weights) against JAX ``make_fused_eval_merged``, balanced
  and long-tailed splits (the JAX side then takes its ragged scan), frozen
  and trainable tables, val and test: per-domain loss at rtol 2e-5; the
  confusion counts exact. Probabilities differ from JAX's by float rounding,
  so a count can flip where a probability lies within rounding of one of the
  500 thresholds: such rows are found, reported, must lie within 1e-5 of a
  threshold, and are set aside (weight 0 on both sides) before the counts are
  compared; with none, the AUCs agree within abs 1e-6;
- the one-weights eval (``make_fused_eval``) against JAX ``make_fused_eval``,
  and ``stack_domains_eval`` bit for bit;
- ``Trainer.val_and_test`` with a ``params_fn`` (per-domain params stacked
  into lanes) against the JAX one, and against MAMDR's merged eval;
- ``EarlyStopper`` sequences.

``make_pair`` is shared with tests/test_torch_finetune.py and
tests/test_torch_run.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamdr_tpu.config import ExperimentConfig as JConfig
from mamdr_tpu.data.synthetic import make_synthetic_dataset as jax_make_synthetic
from mamdr_tpu.metrics import auc as jauc
from mamdr_tpu.strategies.mamdr import MAMDRStrategy as JMAMDR
from mamdr_tpu.train import fused as jfused
from mamdr_tpu.train.trainer import EarlyStopper as JEarlyStopper
from mamdr_tpu.train.trainer import Trainer as JTrainer
from mamdr_tpu_torch.config import ExperimentConfig
from mamdr_tpu_torch.convert import params_from_jax, specific_from_jax
from mamdr_tpu_torch.data.synthetic import make_synthetic_dataset
from mamdr_tpu_torch.metrics import auc as tauc
from mamdr_tpu_torch.strategies import ops
from mamdr_tpu_torch.strategies.mamdr import MAMDRStrategy
from mamdr_tpu_torch.train import fused
from mamdr_tpu_torch.train.trainer import EarlyStopper, Trainer
from mamdr_tpu_torch.utils import trees

EDGE_TOL = 1e-5  # how near a threshold a probability may lie where the two
                 # packages put it on different sides


def make_pair(tmp_path, long_tail=False, emb_trainable=False, n_domain=3, n_per_domain=300,
              batch=32, dataset=None, **train):
    """(JAX trainer, JAX MAMDR strategy, port trainer, port MAMDR strategy)
    on the same data, parameters and specific weights; dropout off."""
    def config(side):
        d = {
            "model": {"name": "mlp_meta_mamdr_finetune", "user_dim": 8, "item_dim": 8,
                      "domain_dim": 8, "hidden_dim": [32, 16], "dropout": 0.0},
            "train": {"load_pretrain_emb": True, "emb_trainable": emb_trainable,
                      "learning_rate": 1e-2, "meta_learning_rate": 0.1, "sample_num": 2,
                      "epoch": 1, "patience": 2,
                      "checkpoint_path": str(tmp_path / side / "ckpt"),
                      "result_save_path": str(tmp_path / side / "result"), **train},
            "dataset": {"name": "synthetic", "batch_size": batch, "seed": 21,
                        **(dataset or {})},
        }
        return d

    kw = dict(n_domain=n_domain, n_uid=50, n_pid=60, n_per_domain=n_per_domain, seed=21,
              long_tail=long_tail, batch_size=batch)
    jds, tds = jax_make_synthetic(**kw), make_synthetic_dataset(**kw)
    for ds in (jds, tds):
        rng = np.random.default_rng(0)
        ds.user_emb = rng.normal(0, 0.1, (50, 8)).astype(np.float32)
        ds.item_emb = rng.normal(0, 0.1, (60, 8)).astype(np.float32)
    jt = JTrainer(JConfig.from_dict(config("jax")), jds, verbose=False)
    js = JMAMDR(jt)
    tt = Trainer(ExperimentConfig.from_dict(config("port")), tds, device="cpu", verbose=False)
    tt.state = tt.state.replace(params=params_from_jax(jax.device_get(jt.state.params)))
    ts = MAMDRStrategy(tt)
    ts.specific = specific_from_jax(jax.device_get(js.specific), ts.mask, ts.shared)
    ts.best_specific = list(ts.specific)
    assert trees.leaves(ts.mask) == jax.tree_util.tree_leaves(js.mask)
    return jt, js, tt, ts


def _jax_counts(probs, labels, weights):
    """[D, S, B] numpy -> the JAX package's [D] AucStates as [D, T] arrays."""
    out = []
    for d in range(probs.shape[0]):
        state = jauc.auc_init(500)
        for s in range(probs.shape[1]):
            state = jauc.auc_update(state, jnp.asarray(labels[d, s]), jnp.asarray(probs[d, s]),
                                    jnp.asarray(weights[d, s]), 500)
        out.append([np.asarray(x) for x in state])
    return [np.stack([o[i] for o in out]) for i in range(4)]


def _port_counts(probs, labels, weights):
    state = tauc.auc_init(500, lanes=(probs.shape[0],))
    for s in range(probs.shape[1]):
        state = tauc.auc_update(state, torch.from_numpy(labels[:, s]),
                                torch.from_numpy(probs[:, s]), torch.from_numpy(weights[:, s]))
    return [x.numpy() for x in state]


def counts_agree(tprobs, jprobs, labels, weights):
    """Hold the port's counts to JAX's on their own probabilities, rows at a
    threshold edge set aside; returns how many rows were."""
    thr = np.asarray(jauc.auc_thresholds(500))
    flips = ((tprobs[..., None] > thr) != (jprobs[..., None] > thr)).any(-1) & (weights > 0)
    if flips.any():
        near = np.abs(jprobs[flips][:, None] - thr).min(-1)
        assert near.max() <= EDGE_TOL, f"a count flips {near.max():.2e} from any threshold"
        print(f"{int(flips.sum())} rows at a threshold edge set aside")
    w = np.where(flips, 0.0, weights).astype(np.float32)
    for name, a, b in zip(tauc.AucState._fields, _port_counts(tprobs, labels, w),
                          _jax_counts(jprobs, labels, w)):
        np.testing.assert_array_equal(a, b, err_msg=name)
    return int(flips.sum())


def _block_np(block):
    return {k: np.asarray(jax.device_get(v)) if not isinstance(v, torch.Tensor) else v.numpy()
            for k, v in block.items()}


def _jax_probs(jt, per_domain_params, block):
    """[D, S, B] probabilities of the JAX loss_fn, domain d with its params."""
    d_count, steps = block["weight"].shape[:2]
    out = np.zeros(block["weight"].shape, np.float32)
    for d in range(d_count):
        for s in range(steps):
            b = {k: jnp.asarray(v[d, s]) for k, v in block.items()}
            out[d, s] = np.asarray(
                jt.loss_fn(per_domain_params[d], {}, b, jax.random.PRNGKey(0), False)[1][1])
    return out


def _port_probs(tt, lane_params, block):
    by_step = [torch.sigmoid(tt.model.apply_lanes(
        lane_params["model"], block["uid"][:, s], block["pid"][:, s], block["domain"][:, s]))
        for s in range(block["uid"].shape[1])]
    return torch.stack(by_step, dim=1).numpy()


@pytest.mark.parametrize("mode", ["val", "test"])
@pytest.mark.parametrize("emb_trainable", [False, True])
@pytest.mark.parametrize("long_tail", [False, True])
def test_merged_eval_matches_jax(tmp_path, long_tail, emb_trainable, mode):
    jt, js, tt, ts = make_pair(tmp_path, long_tail, emb_trainable)
    jstack = jfused.stack_specific(js.specific, js.mask)
    jblock = jt.eval_block(mode)
    jlosses, jaucs = jfused.make_fused_eval_merged(
        jt.loss_fn, js.mask, "plus", steps_list=jt.eval_steps_per_domain(mode))(
        jt.state.params, jt.state.batch_stats, js.shared, jstack, jblock)

    tstack = fused.stack_specific(ts.specific, ts.mask)
    tblock = tt.eval_block(mode)
    tlosses, taucs = fused.make_fused_eval_merged(tt.model, tt.step_cfg, ts.mask, "plus")(
        tt.state.params, ts.shared, tstack, tblock)
    np.testing.assert_allclose(tlosses.numpy(), np.asarray(jlosses), rtol=2e-5)

    # the counts the lane eval formed, against JAX's on JAX's probabilities
    lane_params = ops.load_masked(
        tt.state.params, ops.merge_weights(ts.shared, tstack, ts.mask, "plus"), ts.mask)
    _, counts = fused.make_lane_eval(tt.model, tt.step_cfg)(lane_params, tblock)
    blk = _block_np(tblock)
    tprobs = _port_probs(tt, lane_params, tblock)
    for a, b in zip(counts, _port_counts(tprobs, blk["label"], blk["weight"])):
        np.testing.assert_array_equal(a.numpy(), b)  # the eval's counts are its probs'
    jparams = [js.load_meta(jt.state.params, js.merge(js.shared, js.specific[d]))
               for d in range(3)]
    jprobs = _jax_probs(jt, jparams, blk)
    np.testing.assert_allclose(tprobs, jprobs, rtol=0, atol=1e-6)
    if counts_agree(tprobs, jprobs, blk["label"], blk["weight"]) == 0:
        np.testing.assert_allclose(taucs.numpy(), np.asarray(jaucs), rtol=0, atol=1e-6)


@pytest.mark.parametrize("long_tail", [False, True])
def test_one_weights_eval_matches_jax(tmp_path, long_tail):
    jt, js, tt, ts = make_pair(tmp_path, long_tail)
    for k, v in _block_np(tt.eval_block("val")).items():
        np.testing.assert_array_equal(v, np.asarray(jt.eval_block("val")[k]), err_msg=k)
    jlosses, jaucs = jfused.make_fused_eval(
        jt.loss_fn, 500, steps_list=jt.eval_steps_per_domain("val"))(
        jt.state.params, jt.state.batch_stats, jt.eval_block("val"))
    tlosses, taucs = tt.fused_eval_fn()(tt.state.params, tt.eval_block("val"))
    np.testing.assert_allclose(tlosses.numpy(), np.asarray(jlosses), rtol=2e-5)
    blk = _block_np(tt.eval_block("val"))
    tprobs = _port_probs(tt, tt.state.params, tt.eval_block("val"))
    jprobs = _jax_probs(jt, [jt.state.params] * 3, blk)
    if counts_agree(tprobs, jprobs, blk["label"], blk["weight"]) == 0:
        np.testing.assert_allclose(taucs.numpy(), np.asarray(jaucs), rtol=0, atol=1e-6)


@pytest.mark.parametrize("long_tail", [False, True])
def test_val_and_test_with_params_fn(tmp_path, long_tail):
    """Per-domain params stacked into lanes: the JAX loop over domains, and
    the port's own merged eval (bit for bit: the same merge and forward)."""
    jt, js, tt, ts = make_pair(tmp_path, long_tail)
    jl, ja, jdl, jda = jt.val_and_test("val", params_fn=js.val_params_fn)
    tl, ta, tdl, tda = tt.val_and_test("val", params_fn=ts.val_params_fn)
    np.testing.assert_allclose([tdl[k] for k in jdl], [jdl[k] for k in jdl], rtol=2e-5)
    np.testing.assert_allclose([tda[k] for k in jda], [jda[k] for k in jda], rtol=0, atol=1e-6)
    assert ts.validate() == (tl, ta, tdl, tda)
    assert abs(tt.weighted_auc("val", tda) - jt.weighted_auc("val", jda)) <= 1e-6


@pytest.mark.parametrize("metrics", [
    [0.5, 0.6, 0.6, 0.55, 0.7, 0.69, 0.68],
    [0.5, 0.4, 0.3, 0.2],
    [0.1, 0.1, 0.1],
    [0.2, 0.3, 0.4, 0.5],
])
@pytest.mark.parametrize("patience", [1, 2])
def test_early_stopper_sequences(metrics, patience):
    j, t = JEarlyStopper(patience), EarlyStopper(patience)
    for m in metrics:
        assert t.step(m) == j.step(m)
        assert (t.improved, t.counter, t.best_metric) == (j.improved, j.counter, j.best_metric)


def test_threshold_edge_rows_are_found_and_set_aside():
    """counts_agree's own rule: a probability one ulp on the other side of a
    threshold flips a count; that row is found and set aside, a row farther
    off is refused."""
    thr = np.asarray(jauc.auc_thresholds(500))
    rng = np.random.default_rng(7)
    jprobs = rng.uniform(0, 1, (2, 1, 16)).astype(np.float32)
    jprobs[0, 0, 3] = thr[100]
    tprobs = jprobs.copy()
    tprobs[0, 0, 3] = np.nextafter(thr[100], np.float32(1.0))
    labels = (rng.uniform(0, 1, (2, 1, 16)) < 0.5).astype(np.float32)
    weights = np.ones((2, 1, 16), np.float32)
    assert counts_agree(tprobs, jprobs, labels, weights) == 1
    tprobs[1, 0, 5] = jprobs[1, 0, 5] + 0.01
    with pytest.raises(AssertionError):
        counts_agree(tprobs, jprobs, labels, weights)


@pytest.mark.parametrize("emb_trainable", [False, True])
def test_loss_fn_probabilities_match_jax(tmp_path, emb_trainable):
    """Trainer.loss_fn on one domain's eval batch: (loss with the l2 term,
    data loss, probabilities) against the JAX loss_fn's, and the
    probabilities equal to that domain's lane of the lane forward."""
    jt, js, tt, ts = make_pair(tmp_path, emb_trainable=emb_trainable)
    blk = _block_np(tt.eval_block("val"))
    b = {k: v[1, 0] for k, v in blk.items()}
    jloss, (_, jprobs, jdata) = jt.loss_fn(jt.state.params, {}, {k: jnp.asarray(v) for k, v in
                                                                  b.items()},
                                           jax.random.PRNGKey(0), False)
    tloss, tdata, tprobs = tt.loss_fn(tt.state.params, {k: torch.from_numpy(v) for k, v in
                                                        b.items()}, probs=True)
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), rtol=2e-5)
    np.testing.assert_allclose(tdata.numpy(), np.asarray(jdata), rtol=2e-5)
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs), rtol=0, atol=1e-6)
    lanes = _port_probs(tt, tt.state.params, tt.eval_block("val"))
    np.testing.assert_allclose(tprobs.numpy(), lanes[1, 0], rtol=0, atol=1e-6)
    assert len(tt.loss_fn(tt.state.params, {k: torch.from_numpy(v) for k, v in b.items()})) == 2
