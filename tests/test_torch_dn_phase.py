"""The port's MAMDR Domain-Negotiation phase vs the JAX package's.

- the synthetic dataset is array-equal to the JAX package's (same seed);
- ``run_dn_phase`` draws the domain order and the aux (support) rows from
  numpy exactly as the JAX ``run_fused_epoch`` does, epoch after epoch;
- the DN trajectory (``shared``, params, optimizer slots, per-domain losses)
  matches ``fused.make_fused_mamdr(..., shuffle=False)``'s ``dn_phase`` from
  the same params with dropout off (the JAX package's own equivalence
  recipe), on a long-tailed (ragged) and on a balanced dataset.
  Tolerance rtol 2e-5 with an absolute floor of lr/1000 = 1e-5 on
  parameters (see tests/test_torch_train_step.py): some twenty Adam steps
  on gradients summed in another order.
- the on-device shuffle keeps the pad tail last; the weight-space ops
  (load_masked, reptile_update, merge_weights) equal the JAX package's.
"""

import jax
import numpy as np
import pytest
import torch

from mamdr_tpu.config import ExperimentConfig as JConfig
from mamdr_tpu.data.synthetic import make_synthetic_dataset as jax_make_synthetic
from mamdr_tpu.strategies import ops as jops
from mamdr_tpu.strategies.mamdr import MAMDRStrategy as JMAMDR
from mamdr_tpu.train import fused as jfused
from mamdr_tpu.train.trainer import Trainer as JTrainer
from mamdr_tpu_torch.config import ExperimentConfig
from mamdr_tpu_torch.convert import params_from_jax
from mamdr_tpu_torch.data.synthetic import make_synthetic_dataset
from mamdr_tpu_torch.strategies import ops as tops
from mamdr_tpu_torch.strategies.mamdr import MAMDRStrategy
from mamdr_tpu_torch.train import fused
from mamdr_tpu_torch.train.trainer import Trainer
from mamdr_tpu_torch.utils import trees

BATCH = 32


def _config(tmp_path, n_domain, sample_num=5, lr=1e-2):
    d = {
        "model": {"name": "mlp_meta_mamdr_finetune", "user_dim": 8, "item_dim": 8,
                  "domain_dim": 8, "hidden_dim": [32, 16], "dropout": 0.0},
        "train": {"load_pretrain_emb": True, "emb_trainable": False,
                  "learning_rate": lr, "meta_learning_rate": 0.1,
                  "sample_num": sample_num, "add_query_domain": True,
                  "shuffle_sequence": True, "metrics_jsonl": False,
                  "checkpoint_path": str(tmp_path / "ckpt"),
                  "result_save_path": str(tmp_path / "result")},
        "dataset": {"name": "synthetic", "batch_size": BATCH, "seed": 21},
    }
    return JConfig.from_dict(d), ExperimentConfig.from_dict(d)


def _datasets(n_domain, long_tail, n_per_domain=400):
    kw = dict(n_domain=n_domain, n_uid=50, n_pid=60, n_per_domain=n_per_domain,
              seed=21, long_tail=long_tail, batch_size=BATCH)
    jds, tds = jax_make_synthetic(**kw), make_synthetic_dataset(**kw)
    rng = np.random.default_rng(0)
    for ds in (jds, tds):
        ds.user_emb = rng.normal(0, 0.1, (50, 8)).astype(np.float32)
        ds.item_emb = rng.normal(0, 0.1, (60, 8)).astype(np.float32)
        rng = np.random.default_rng(0)
    return jds, tds


@pytest.mark.parametrize("long_tail", [True, False])
def test_synthetic_dataset_array_equal(long_tail):
    jds, tds = _datasets(4, long_tail)
    assert (tds.n_uid, tds.n_pid, tds.n_domain) == (jds.n_uid, jds.n_pid, jds.n_domain)
    for split in ("train", "val", "test"):
        for a, b in zip(getattr(tds, split), getattr(jds, split)):
            for col in ("uid", "pid", "domain", "label"):
                x, y = getattr(a, col), getattr(b, col)
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
    assert tds.dataset_info == jds.dataset_info


def test_epoch_draws_match_jax(tmp_path):
    """Domain order and aux rows, two epochs running: the numpy streams of
    the two packages stay in step."""
    jcfg, tcfg = _config(tmp_path, 5, sample_num=3)
    jds, tds = _datasets(5, True, n_per_domain=200)
    jt = JTrainer(jcfg, jds, verbose=False)
    js = JMAMDR(jt)
    seen = []

    def dn(state, shared, block, order, rng, lr):
        seen.append(("order", np.asarray(order)))
        return state, shared, None

    def dr(state, shared, spec, block, order, aux, rng, lr):
        seen.append(("aux", np.asarray(aux)))
        return state, spec

    js._block, js._spec_stack = None, None
    js._dn_phase, js._dr_phase = dn, dr
    js._dn_compiled = js._dr_compiled = None

    tt = Trainer(tcfg, tds, device="cpu")
    ts = MAMDRStrategy(tt)
    ts.prepare_fused()
    for epoch in range(2):
        js.run_fused_epoch()
        losses = ts.run_dn_phase()
        assert losses.shape == (5,) and np.all(np.isfinite(losses))
        np.testing.assert_array_equal(ts.order, seen[2 * epoch][1])
        np.testing.assert_array_equal(ts.aux, seen[2 * epoch + 1][1])
        assert ts.aux.shape == (5, 4)
    assert tt.np_rng.bit_generator.state == jt.np_rng.bit_generator.state


def _assert_close(a, b, rtol=2e-5, atol=1e-5, what=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("long_tail", [True, False])
def test_dn_phase_trajectory_matches_jax(tmp_path, long_tail):
    jcfg, tcfg = _config(tmp_path, 3)
    jds, tds = _datasets(3, long_tail)
    order = np.asarray([2, 0, 1], np.int32)

    jt = JTrainer(jcfg, jds, verbose=False)
    js = JMAMDR(jt)
    jblock, n_steps = jfused.stack_domains_on_device(jds.train, BATCH)
    jdn, _ = jfused.make_fused_mamdr(
        jt.train_step_fn(), js.mask, "plus", n_steps, BATCH, shuffle=False,
        steps_list=jt.steps_per_domain(),
    )
    jstate, jshared, jlosses = jdn(jt.state, js.shared, jblock, order,
                                   jax.random.PRNGKey(0), 0.1)

    tt = Trainer(tcfg, tds, device="cpu")
    tt.state = tt.state.replace(params=params_from_jax(jax.device_get(jt.state.params)))
    ts = MAMDRStrategy(tt)
    tblock, t_steps = tt.train_block()
    assert t_steps == n_steps
    for k in tblock:
        np.testing.assert_array_equal(tblock[k].numpy(), np.asarray(jblock[k]))
    tdn = fused.make_fused_mamdr(tt.train_step_fn(), ts.mask, t_steps, BATCH,
                                 steps_list=tt.steps_per_domain(), shuffle=False)
    shared0 = ts.shared
    tstate, tshared, tlosses = tdn(tt.state, ts.shared, tblock, order, tt.gen, 0.1)

    assert int(tstate.step) == int(jstate.step) == sum(tt.steps_per_domain())
    _assert_close(tlosses.numpy(), jlosses, atol=1e-7, what="losses")
    jnamed = lambda tree: dict(zip(trees.param_names(jax.device_get(tree)),
                                   jax.tree_util.tree_leaves(tree)))
    for tree_t, tree_j, what in ((tshared, jshared, "shared"),
                                 (tstate.params, jstate.params, "params")):
        jn = jnamed(tree_j)
        for name, leaf in trees.leaves_with_names(tree_t):
            _assert_close(leaf.numpy(), jn[name], what=f"{what}:{name}")
    _assert_close(tstate.opt_state.mu.numpy(), jstate.opt_state.mu, atol=1e-8, what="mu")
    # frozen tables pass through untouched (the same tensors), trained ones moved
    assert tshared["model"]["embedding"]["user_emb"] is shared0["model"]["embedding"]["user_emb"]
    assert not torch.equal(tshared["model"]["dnn"]["Dense_0"]["Dense_0"]["kernel"],
                           shared0["model"]["dnn"]["Dense_0"]["Dense_0"]["kernel"])


def test_shuffled_batches_keep_pad_tail_last():
    """The on-device shuffle permutes only the real rows, keeps the weight-0
    tail last, and the packed int32 gather returns float columns bit-exact."""
    _, tds = _datasets(3, True)
    block, n_steps = fused.stack_domains_on_device(tds.train, BATCH, "cpu")
    gen = torch.Generator().manual_seed(0)
    for d, split in enumerate(tds.train):
        flat = {k: v[d] for k, v in block.items()}
        steps = -(-split.n // BATCH)
        b = fused._form_batches(flat, gen, n_steps, BATCH, cap_steps=steps)
        w = b["weight"].reshape(-1)
        assert b["uid"].shape == (steps, BATCH) and b["uid"].is_contiguous()
        assert int(w.sum()) == split.n and bool(torch.all(w[: split.n] == 1.0))
        rows = sorted(zip(b["uid"].reshape(-1)[: split.n].tolist(),
                          b["pid"].reshape(-1)[: split.n].tolist(),
                          b["label"].reshape(-1)[: split.n].tolist()))
        assert rows == sorted(zip(split.uid.tolist(), split.pid.tolist(),
                                  split.label.tolist()))
        assert bool(torch.all(b["domain"] == d))
    natural = fused._form_batches({k: v[0] for k, v in block.items()}, gen, n_steps,
                                  BATCH, shuffle=False)
    np.testing.assert_array_equal(natural["label"].reshape(-1).numpy(),
                                  block["label"][0].numpy())


@pytest.mark.parametrize("method", ["plus", "times"])
def test_weight_space_ops_match_jax(method):
    rng = np.random.default_rng(0)
    mk = lambda: {"a": {"k": rng.normal(size=(3, 2)).astype(np.float32)},
                  "b": rng.normal(size=4).astype(np.float32)}
    x, y = mk(), mk()
    mask = {"a": {"k": True}, "b": False}
    tx, ty = params_from_jax(x), params_from_jax(y)
    for jt, tt in (
        (jops.load_masked(x, y, mask), tops.load_masked(tx, ty, mask)),
        (jops.reptile_update(x, y, 0.1, mask), tops.reptile_update(tx, ty, 0.1, mask)),
        (jops.merge_weights(x, y, mask, method), tops.merge_weights(tx, ty, mask, method)),
    ):
        for (name, leaf), want in zip(trees.leaves_with_names(tt), trees.leaves(jt)):
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(want), err_msg=name)
        assert tt["b"] is tx["b"]  # unmasked leaves pass through by reference
