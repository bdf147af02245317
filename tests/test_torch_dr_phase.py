"""The port's MAMDR Domain-Regularization phase and whole epoch vs the JAX package's.

Both sides run the JAX package's own equivalence recipe — ``shuffle=False``,
dropout off, flat Adam — from the same parameters (``convert.params_from_jax``),
the same specific stack (``convert.spec_stack_from_jax``) and, where DR starts
after a DN phase, the same optimizer slots:

- the sequential ``dr_phase`` of ``make_fused_mamdr`` against the JAX one, on
  balanced and long-tailed data, ``domain_regulation_step`` 0 and 1;
- the lanes (``make_fused_dr_parallel`` over ``make_subset_train_step``) against
  the JAX lanes, frozen and trainable tables, ragged and not, including the
  returned last-lane state;
- ``run_fused_epoch`` for two epochs against the JAX ``run_fused_epoch``, the
  numpy streams of the two packages staying in step;
- the eligibility gate.

Tolerances: rtol 2e-5 with an absolute floor of 1e-5 on parameters (a few
dozen Adam steps on gradients summed in another order: Adam turns last-bit
differences of near-zero gradients into steps of order lr, see
tests/test_torch_train_step.py), 1e-8 on ``mu``.
"""

import jax
import numpy as np
import pytest
import torch

from mamdr_tpu.config import ExperimentConfig as JConfig
from mamdr_tpu.data.synthetic import make_synthetic_dataset as jax_make_synthetic
from mamdr_tpu.strategies.mamdr import MAMDRStrategy as JMAMDR
from mamdr_tpu.train import fused as jfused
from mamdr_tpu.train.steps import make_subset_train_step as jax_make_subset_train_step
from mamdr_tpu.train.trainer import Trainer as JTrainer
from mamdr_tpu.utils import trees as jtrees
from mamdr_tpu_torch.config import ExperimentConfig
from mamdr_tpu_torch.convert import (
    flat_adam_state_from_jax,
    params_from_jax,
    spec_stack_from_jax,
)
from mamdr_tpu_torch.data.synthetic import make_synthetic_dataset
from mamdr_tpu_torch.strategies.mamdr import MAMDRStrategy
from mamdr_tpu_torch.train import fused
from mamdr_tpu_torch.train.steps import make_subset_train_step
from mamdr_tpu_torch.train.trainer import Trainer
from mamdr_tpu_torch.utils import trees

BATCH = 32
N_DOMAIN = 3
ORDER = np.asarray([2, 0, 1], np.int32)
AUX = np.asarray([[0, 1, 2], [2, 1, 0], [0, 2, 1]], np.int32)  # [query position, K]


def _configs(tmp_path, emb_trainable=False, **train):
    d = {
        "model": {"name": "mlp_meta_mamdr_finetune", "user_dim": 8, "item_dim": 8,
                  "domain_dim": 8, "hidden_dim": [32, 16], "dropout": 0.0},
        "train": {"load_pretrain_emb": True, "emb_trainable": emb_trainable,
                  "learning_rate": 1e-2, "meta_learning_rate": 0.1,
                  "sample_num": 2, "add_query_domain": True,
                  "shuffle_sequence": True, "metrics_jsonl": False,
                  "checkpoint_path": str(tmp_path / "ckpt"),
                  "result_save_path": str(tmp_path / "result"), **train},
        "dataset": {"name": "synthetic", "batch_size": BATCH, "seed": 21},
    }
    return JConfig.from_dict(d), ExperimentConfig.from_dict(d)


def _datasets(long_tail, n_domain=N_DOMAIN):
    kw = dict(n_domain=n_domain, n_uid=50, n_pid=60, n_per_domain=300, seed=21,
              long_tail=long_tail, batch_size=BATCH)
    jds, tds = jax_make_synthetic(**kw), make_synthetic_dataset(**kw)
    for ds in (jds, tds):
        rng = np.random.default_rng(0)
        ds.user_emb = rng.normal(0, 0.1, (50, 8)).astype(np.float32)
        ds.item_emb = rng.normal(0, 0.1, (60, 8)).astype(np.float32)
    return jds, tds


def _pair(tmp_path, long_tail, emb_trainable=False, **train):
    """(JAX trainer, JAX strategy, port trainer, port strategy) on the same
    data, params and specific weights."""
    jcfg, tcfg = _configs(tmp_path, emb_trainable, **train)
    jds, tds = _datasets(long_tail)
    jt = JTrainer(jcfg, jds, verbose=False)
    js = JMAMDR(jt)
    tt = Trainer(tcfg, tds, device="cpu")
    tt.state = tt.state.replace(params=params_from_jax(jax.device_get(jt.state.params)))
    ts = MAMDRStrategy(tt)
    jstack = jfused.stack_specific(js.specific, js.mask)
    ts._spec_stack = spec_stack_from_jax(jax.device_get(jstack), ts.mask, ts.shared)
    ts.specific = fused.unstack_specific(ts._spec_stack, ts.mask, N_DOMAIN)
    assert trees.leaves(ts.mask) == jax.tree_util.tree_leaves(js.mask)
    return jt, js, tt, ts


def _jax_phases(jt, js, lanes, reg_step=0):
    """The JAX (dn_phase, dr_phase) with shuffles off; dr as lanes if asked."""
    block, n_steps = jt.train_block()
    steps = jt.steps_per_domain()
    dn, dr = jfused.make_fused_mamdr(
        jt.train_step_fn(), js.mask, "plus", n_steps, BATCH, reg_step, shuffle=False,
        steps_list=steps)
    if lanes:
        frozen = jtrees.named_tree_map(
            lambda n, x: (not js.tc.emb_trainable) and ("user_emb" in n or "item_emb" in n),
            jt.state.params)
        sub_step, to_sub, combine = jax_make_subset_train_step(
            jt.model, jt.tx, jt.step_cfg, frozen, jt.state.params)
        dr = jfused.make_fused_dr_parallel(
            sub_step, to_sub, combine, js.mask, "plus", n_steps, BATCH, reg_step,
            shuffle=False, steps_list=steps)
    return block, dn, dr


def _port_phases(tt, ts, lanes, reg_step=0):
    block, n_steps = tt.train_block()
    steps = tt.steps_per_domain()
    dn, dr = fused.make_fused_mamdr(
        tt.train_step_fn(), ts.mask, "plus", n_steps, BATCH, reg_step, shuffle=False,
        steps_list=steps)
    if lanes:
        sub_step, to_sub, combine = make_subset_train_step(
            tt.model, tt.tx, tt.step_cfg, tt.frozen_mask(), tt.state.params)
        dr = fused.make_fused_dr_parallel(
            sub_step, to_sub, combine, ts.mask, "plus", n_steps, BATCH, reg_step,
            shuffle=False, steps_list=steps)
    return block, dn, dr


def _close(a, b, what, rtol=2e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol,
                               err_msg=what)


def _trees_close(port_tree, jax_tree, what):
    named = dict(zip(trees.param_names(jax.device_get(jax_tree)),
                     jax.tree_util.tree_leaves(jax_tree)))
    for name, leaf in trees.leaves_with_names(port_tree):
        _close(leaf.numpy(), named[name], f"{what}:{name}")


def _states_close(tstate, jstate):
    assert int(tstate.step) == int(jstate.step)
    assert int(tstate.opt_state.count) == int(jstate.opt_state.count)
    _trees_close(tstate.params, jstate.params, "params")
    _close(tstate.opt_state.mu.numpy(), jstate.opt_state.mu, "mu", atol=1e-8)


@pytest.mark.parametrize("reg_step", [0, 1])
@pytest.mark.parametrize("long_tail", [True, False])
def test_sequential_dr_phase_matches_jax(tmp_path, long_tail, reg_step):
    jt, js, tt, ts = _pair(tmp_path, long_tail)
    jblock, _, jdr = _jax_phases(jt, js, lanes=False, reg_step=reg_step)
    jstate, jstack = jdr(jt.state, js.shared, jfused.stack_specific(js.specific, js.mask),
                         jblock, ORDER, AUX, jax.random.PRNGKey(0), 0.1)
    tblock, _, tdr = _port_phases(tt, ts, lanes=False, reg_step=reg_step)
    stack0 = ts._spec_stack
    tstate, tstack = tdr(tt.state, ts.shared, stack0, tblock, ORDER, AUX, tt.gen, 0.1)

    steps = tt.steps_per_domain()
    cap = (lambda s: min(s, reg_step)) if reg_step else (lambda s: s)
    assert int(tstate.step) == sum(steps[s] + cap(steps[q])
                                   for q, row in zip(ORDER, AUX) for s in row)
    _states_close(tstate, jstate)
    _trees_close(tstack, jstack, "specific stack")
    emb = tstack["model"]["embedding"]
    assert emb["user_emb"] is ts.shared["model"]["embedding"]["user_emb"]  # never copied
    assert not torch.equal(emb["domain_emb"], stack0["model"]["embedding"]["domain_emb"])


@pytest.mark.parametrize("long_tail", [True, False])
@pytest.mark.parametrize("emb_trainable", [False, True])
def test_dr_lanes_match_jax_lanes(tmp_path, emb_trainable, long_tail):
    """Lanes after a DN phase, so that DR starts from non-zero slots and a
    non-zero step counter on both sides."""
    jt, js, tt, ts = _pair(tmp_path, long_tail, emb_trainable)
    jblock, jdn, jdr = _jax_phases(jt, js, lanes=True)
    jstate, jshared, _ = jdn(jt.state, js.shared, jblock, ORDER, jax.random.PRNGKey(0), 0.1)
    # the port starts DR from the JAX side's DR-entry state
    opt = jax.device_get(jstate.opt_state)
    entry = tt.state.replace(
        params=params_from_jax(jax.device_get(jstate.params)),
        opt_state=flat_adam_state_from_jax(opt.count, opt.mu, opt.nu),
        step=torch.tensor(int(jstate.step), dtype=torch.int32))
    tshared = params_from_jax(jax.device_get(jshared))
    if not emb_trainable:  # frozen tables: the very same tensors everywhere
        for tree in (entry.params, tshared):
            for name in ("user_emb", "item_emb"):
                tree["model"]["embedding"][name] = ts.shared["model"]["embedding"][name]

    jstate, jstack = jdr(jstate, jshared, jfused.stack_specific(js.specific, js.mask),
                         jblock, ORDER, AUX, jax.random.PRNGKey(1), 0.1)
    tblock, _, tdr = _port_phases(tt, ts, lanes=True)
    tstate, tstack = tdr(entry, tshared, ts._spec_stack, tblock, ORDER, AUX, tt.gen, 0.1)

    # the returned state is the last lane's: DR-entry step + that lane's real steps
    steps = tt.steps_per_domain()
    assert int(tstate.step) == int(entry.step) + sum(
        steps[s] + steps[ORDER[-1]] for s in AUX[-1])
    _states_close(tstate, jstate)
    _trees_close(tstack, jstack, "specific stack")
    if not emb_trainable:
        assert (tstate.params["model"]["embedding"]["user_emb"]
                is ts.shared["model"]["embedding"]["user_emb"])
    assert tstate.seed == entry.seed  # the lane seeds do not leak out


@pytest.mark.parametrize("lanes", [False, True])
def test_run_fused_epoch_matches_jax(tmp_path, lanes):
    """Two whole epochs (draws, DN, DR) with both sides' shuffles off."""
    jt, js, tt, ts = _pair(tmp_path, long_tail=True)
    js._block, js._dn_phase, js._dr_phase = _jax_phases(jt, js, lanes)
    js._spec_stack = jfused.stack_specific(js.specific, js.mask)
    js._dn_compiled = js._dr_compiled = None
    ts.prepare_fused()
    assert ts.dr_lanes  # "auto" on an eligible model
    stack = ts._spec_stack
    ts._block, ts._dn_phase, ts._dr_phase = _port_phases(tt, ts, lanes)
    assert ts._spec_stack is stack
    for _ in range(2):
        js.run_fused_epoch()
        losses = ts.run_fused_epoch()
        assert losses.shape == (N_DOMAIN,) and np.all(np.isfinite(losses))
    assert tt.np_rng.bit_generator.state == jt.np_rng.bit_generator.state
    _states_close(tt.state, jt.state)
    _trees_close(ts.shared, js.shared, "shared")
    _trees_close(ts._spec_stack, js._spec_stack, "specific stack")
    for d, spec in enumerate(ts.specific):  # refreshed from the stack
        assert torch.equal(spec["model"]["embedding"]["domain_emb"],
                           ts._spec_stack["model"]["embedding"]["domain_emb"][d])


def _strategy(tmp_path, **train):
    _, tcfg = _configs(tmp_path, **train)
    _, tds = _datasets(long_tail=True)
    return MAMDRStrategy(Trainer(tcfg, tds, device="cpu"))


def test_dr_parallel_gate(tmp_path):
    off = _strategy(tmp_path, dr_parallel="off")
    off.prepare_fused()
    assert not off.dr_lanes
    auto = _strategy(tmp_path)
    auto.prepare_fused()
    assert auto.dr_lanes
    # a trainable leaf outside the meta mask needs the sequential lineage
    hidden = dict(meta_parms=["all_hidden"])  # leaves the domain table uncovered
    seq = _strategy(tmp_path, **hidden)
    seq.prepare_fused()
    assert not seq.dr_lanes
    with pytest.raises(ValueError, match="domain_emb"):
        _strategy(tmp_path, dr_parallel="on", **hidden).prepare_fused()
    chunked = _strategy(tmp_path, dr_lane_chunk=2)  # lanes in groups of 2
    chunked.prepare_fused()
    assert chunked.dr_lanes and chunked._dr_lane_chunk_effective == 2
    with pytest.raises(ValueError, match="dr_parallel"):
        _strategy(tmp_path, dr_parallel="maybe").prepare_fused()
