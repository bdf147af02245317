"""bfloat16 towers (``model.compute_dtype: "bfloat16"``) in the port vs flax.

flax ``nn.Dense(dtype=bfloat16)`` promotes input, kernel and bias to bf16
and returns a bf16 product; the ReLU and the hash dropout run on it; the
logit head returns float32; the params stay float32. The logits, the loss
and the kernels' and tables' gradients are held to 1e-5 of each tensor's
largest magnitude (measured: at most 3.6e-7; the logits and the kernels'
gradients bit-equal). The Dense biases' gradients are held to 5e-2 of
theirs: XLA sums their bf16 cotangent over the batch serially in bf16,
rounding after every row, where the port sums in float32 and rounds once,
so over the 24 rows here they part by up to 2.0e-2.

- the MLP's and DeepFM's logits, loss and every gradient leaf (autograd,
  frozen and trainable tables) against ``jax.value_and_grad`` of the JAX
  loss, with and without dropout;
- the control: the same models computing in float32 fail that limit (the
  logits by 1.5e-3 to 6.9e-3 of their max, the kernels' gradients by up to
  3.6e-2);
- a short ``run()`` (3 epochs) of ``mlp`` and ``mmoe`` against the JAX
  package's: per-domain test loss within 2e-3 relative (measured: up to
  5.6e-4; a float32 tower in the port against the JAX package's bf16 run
  parts by 1.1e-3 to 3.9e-3, so the run is no sharp control: the tensors
  above are), AUC within 3e-2 — a domain's test split holds 14 to 20 rows
  (48 to 100 positive-negative pairs), so one pair the two runs order
  differently moves its AUC by 1e-2 to 2.1e-2, a tie by half that
  (measured: 1.02e-2 on one domain); MMoE accepts the key and computes in
  float32 in both packages, so its run is held at the float32 tolerances of
  tests/test_torch_zoo_mtl_run.py;
- the K1 gate: a bf16 MLP takes autograd (K1 computes float32), a float32
  MLP the fused kernel path, as JAX ops/fused_mlp_step.py:227 decides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamdr_tpu.config import ExperimentConfig as JConfig
from mamdr_tpu.data.synthetic import make_synthetic_dataset as jax_make_synthetic
from mamdr_tpu.strategies import build_strategy as jbuild_strategy
from mamdr_tpu.train.steps import StepConfig as JStepConfig
from mamdr_tpu.train.steps import make_loss_fn as jax_make_loss_fn
from mamdr_tpu.train.trainer import Trainer as JTrainer
from mamdr_tpu_torch.config import ExperimentConfig
from mamdr_tpu_torch.convert import params_from_jax
from mamdr_tpu_torch.data.synthetic import make_synthetic_dataset
from mamdr_tpu_torch.strategies.base import build_strategy
from mamdr_tpu_torch.train.steps import StepConfig, make_autograd_loss_grad, make_loss_grad
from mamdr_tpu_torch.train.trainer import Trainer
from mamdr_tpu_torch.utils import trees
from test_torch_strategies import results_close
from test_torch_zoo import jnamed, make_models, model_dict, tbatch

BF16_TOL = 1e-5       # of a tensor's largest magnitude (see above)
BF16_BIAS_TOL = 5e-2  # a Dense bias's gradient (see above)
RUN_LOSS_TOL = 2e-3   # a run()'s per-domain test loss, relative (see above)
RUN_AUC_TOL = 3e-2    # about one positive-negative pair of a test split (see above)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-12)


def _errors_against_flax_bf16(name, emb_trainable, dropout, monkeypatch, port_dtype):
    """{tensor: its largest difference over its largest magnitude}: the
    logits, the loss and every gradient leaf of the port's model computing
    in ``port_dtype`` against flax's computing in bfloat16, on the same
    parameters, batch and dropout masks. Checks the dtypes on the way."""
    jmodel, _, jparams, tparams, batch = make_models(name, dropout, compute_dtype="bfloat16")
    _, tmodel, _, _, _ = make_models(name, dropout, compute_dtype=port_dtype)
    assert tmodel.dnn.Dense_0.Dense_0.dtype == (torch.bfloat16 if port_dtype == "bfloat16"
                                                else None)  # None: float32 as given
    assert all(x.dtype == torch.float32 for x in trees.leaves(tmodel.param_tree()))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    seeds = [17 + 1000 * i for i in range(tmodel.n_dropout_sites)]
    if dropout:  # the JAX model draws the same hash-mask seeds in call order
        import mamdr_tpu.ops.fast_random as jfast_random

        it = iter(seeds)
        monkeypatch.setattr(jfast_random, "key_to_seed", lambda key: jnp.uint32(next(it)))
    want = jmodel.apply({"params": jparams}, jb["uid"], jb["pid"], jb["domain"],
                        train=bool(dropout), rngs={"dropout": jax.random.PRNGKey(0)})
    assert want.dtype == jnp.float32
    tb = tbatch(batch)
    tseeds = torch.tensor(seeds, dtype=torch.int64) if dropout else None
    got = tmodel.apply(tparams, tb["uid"], tb["pid"], tb["domain"], tseeds)
    assert got.dtype == torch.float32
    errors = {"logits": _rel(got.detach().numpy(), want)}

    if dropout:
        it = iter(seeds)
    jloss_fn = jax_make_loss_fn(jmodel, JStepConfig(emb_trainable=emb_trainable,
                                                    has_dropout=bool(dropout)))
    (_, (_, _, jdata)), jg = jax.value_and_grad(jloss_fn, has_aux=True)(
        {"model": jparams}, {}, jb, jax.random.PRNGKey(0), bool(dropout))
    tdata, tg = make_autograd_loss_grad(tmodel, StepConfig(emb_trainable=emb_trainable))(
        {"model": tparams}, tb, tseeds, train=bool(dropout))
    errors["loss"] = _rel(float(tdata), float(jdata))
    jgn = jnamed(jg)
    for n, g in trees.leaves_with_names(tg):
        if g is None:
            assert not emb_trainable and ("user_emb" in n or "item_emb" in n), n
            continue
        assert g.dtype == torch.float32, n
        errors[n] = _rel(g.numpy(), jgn[n])
    return errors


CASES = [("mlp", False, 0.0), ("mlp", True, 0.5), ("deepfm", False, 0.5), ("deepfm", True, 0.0)]


@pytest.mark.parametrize("name,emb_trainable,dropout", CASES)
def test_logits_and_gradients_match_flax_in_bf16(name, emb_trainable, dropout, monkeypatch):
    errors = _errors_against_flax_bf16(name, emb_trainable, dropout, monkeypatch, "bfloat16")
    for what, err in errors.items():
        tol = BF16_BIAS_TOL if what.endswith("/bias") else BF16_TOL
        assert err <= tol, f"{what}: {err:.3e} of its max (tol {tol})"


@pytest.mark.parametrize("name,emb_trainable,dropout", CASES)
def test_a_float32_tower_fails_the_bf16_limit(name, emb_trainable, dropout, monkeypatch):
    """The control: the same model computing in float32 against flax's
    bf16 output parts by far more than BF16_TOL (measured: the logits by
    1.5e-3 to 6.9e-3 of their max, every kernel's gradient by 2.7e-3 to
    3.6e-2), so the limit above would catch a port that quietly computed
    the tower in float32. (The mean loss washes the rows' roundings out to
    1.5e-5 to 4.2e-5; it is not used as the control.)"""
    errors = _errors_against_flax_bf16(name, emb_trainable, dropout, monkeypatch, "float32")
    assert errors["logits"] > 10 * BF16_TOL, errors["logits"]
    kernels = [e for w, e in errors.items() if w.endswith("/kernel")]
    assert max(kernels) > 10 * BF16_TOL, kernels


def _pair(tmp_path, name, emb_trainable):
    """A JAX and a port strategy of `name` in bf16 on the same data and
    parameters (tests/test_torch_zoo_run.py's zoo_pair, with the dtype)."""
    def config(side):
        return {
            "model": model_dict(name, compute_dtype="bfloat16"),
            "train": {"load_pretrain_emb": True, "emb_trainable": emb_trainable,
                      "learning_rate": 1e-2, "epoch": 3, "patience": 2,
                      "checkpoint_path": str(tmp_path / side / "ckpt"),
                      "result_save_path": str(tmp_path / side / "result")},
            "dataset": {"name": "synthetic", "batch_size": 64, "seed": 21},
        }

    kw = dict(n_domain=3, n_uid=50, n_pid=60, n_per_domain=100, seed=21, batch_size=64)
    jds, tds = jax_make_synthetic(**kw), make_synthetic_dataset(**kw)
    for ds in (jds, tds):
        rng = np.random.default_rng(0)
        ds.user_emb = rng.normal(0, 0.1, (50, 8)).astype(np.float32)
        ds.item_emb = rng.normal(0, 0.1, (60, 8)).astype(np.float32)
    jt = JTrainer(JConfig.from_dict(config("jax")), jds, verbose=False)
    tt = Trainer(ExperimentConfig.from_dict(config("port")), tds, device="cpu", verbose=False)
    tt.state = tt.state.replace(params=params_from_jax(jax.device_get(jt.state.params)))
    return jt, jbuild_strategy(jt), tt, build_strategy(tt)


@pytest.mark.parametrize("name,emb_trainable", [("mlp", False), ("mlp", True),
                                                ("mmoe", False)])
def test_run_matches_jax_in_bf16(tmp_path, name, emb_trainable):
    jt, js, tt, ts = _pair(tmp_path, name, emb_trainable)
    assert max(tt.steps_per_domain()) == 1
    params0 = tt.state.params
    jres, tres = js.run(), ts.run()
    if name == "mmoe":  # computes in float32 in both packages
        results_close(tres, jres)
    else:
        _, _, tdl, tda = tres
        _, _, jdl, jda = jres
        assert sorted(tdl) == sorted(jdl)
        np.testing.assert_allclose([tdl[k] for k in jdl], [jdl[k] for k in jdl],
                                   rtol=RUN_LOSS_TOL)
        np.testing.assert_allclose([tda[k] for k in jda], [jda[k] for k in jda], rtol=0,
                                   atol=RUN_AUC_TOL)
    moved = [not torch.equal(a, b) for a, b in zip(trees.leaves(tt.state.params),
                                                    trees.leaves(params0))]
    assert any(moved)
    assert all(bool(torch.isfinite(x).all()) for x in trees.leaves(tt.state.params))


def test_k1_gate_sends_bf16_to_autograd():
    cfg = StepConfig()
    _, f32, _, _, _ = make_models("mlp")
    _, bf16, _, _, _ = make_models("mlp", compute_dtype="bfloat16")
    assert "make_fast_loss_grad" in make_loss_grad(f32, cfg).__qualname__
    assert "make_autograd_loss_grad" in make_loss_grad(bf16, cfg).__qualname__
