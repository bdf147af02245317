"""The DR lanes in groups (``make_fused_dr_parallel(..., lane_chunk=C)``) vs
the JAX package's chunked lanes and vs the port's own whole-lane dispatch.

By the recipe of tests/test_torch_dr_phase.py (flat Adam, dropout off, the
same parameters, specific stack and DR-entry state on both sides), at 5
query domains:

- the port's lanes at C 2 and 3 against the JAX lanes at the same C, with
  frozen and with trainable tables, shuffles off: rtol 2e-5 / atol 1e-5 on
  parameters, 1e-8 on ``mu``, the step counters equal;
- the port's lanes at C 2 and 3 against its own lanes at C 0 (all at once),
  shuffles ON (every epoch's keys drawn for all lanes before the first
  group) and dropout on: bit for bit, the device generator left in the same
  state;
- ``_dr_lane_chunk_effective`` as tests/test_fused.py pins the JAX rule:
  7 with trainable tables and more than 7 domains, 0 for a narrow fan or
  frozen tables, an explicit ``dr_lane_chunk`` wins; and the memory gate
  counting min(n_domain, C) lanes.
"""

import jax
import numpy as np
import pytest
import torch

from mamdr_tpu.strategies.mamdr import MAMDRStrategy as JMAMDR
from mamdr_tpu.train import fused as jfused
from mamdr_tpu.train.steps import make_subset_train_step as jax_make_subset_train_step
from mamdr_tpu.train.trainer import Trainer as JTrainer
from mamdr_tpu.utils import trees as jtrees
from mamdr_tpu_torch.convert import flat_adam_state_from_jax, params_from_jax, spec_stack_from_jax
from mamdr_tpu_torch.strategies.mamdr import MAMDRStrategy
from mamdr_tpu_torch.train import fused
from mamdr_tpu_torch.train.steps import make_subset_train_step
from mamdr_tpu_torch.train.trainer import Trainer
from mamdr_tpu_torch.utils import trees
from test_torch_dr_phase import BATCH, _configs, _datasets, _states_close, _trees_close

N_DOMAIN = 5
ORDER = np.asarray([3, 0, 4, 1, 2], np.int32)
AUX = np.asarray([[0, 1, 3], [2, 4, 0], [1, 3, 4], [4, 0, 1], [3, 2, 2]], np.int32)


def _pair(tmp_path, emb_trainable, **train):
    jcfg, tcfg = _configs(tmp_path, emb_trainable, **train)
    jds, tds = _datasets(long_tail=True, n_domain=N_DOMAIN)
    jt = JTrainer(jcfg, jds, verbose=False)
    js = JMAMDR(jt)
    tt = Trainer(tcfg, tds, device="cpu")
    tt.state = tt.state.replace(params=params_from_jax(jax.device_get(jt.state.params)))
    ts = MAMDRStrategy(tt)
    jstack = jfused.stack_specific(js.specific, js.mask)
    ts._spec_stack = spec_stack_from_jax(jax.device_get(jstack), ts.mask, ts.shared)
    return jt, js, tt, ts


def _port_lanes(tt, ts, chunk, shuffle=False):
    block, n_steps = tt.train_block()
    sub_step, to_sub, combine = make_subset_train_step(
        tt.model, tt.tx, tt.step_cfg, tt.frozen_mask(), tt.state.params)
    return block, fused.make_fused_dr_parallel(
        sub_step, to_sub, combine, ts.mask, "plus", n_steps, BATCH, shuffle=shuffle,
        steps_list=tt.steps_per_domain(), lane_chunk=chunk)


@pytest.mark.parametrize("chunk", [2, 3])
@pytest.mark.parametrize("emb_trainable", [False, True])
def test_chunked_lanes_match_jax_chunked_lanes(tmp_path, emb_trainable, chunk):
    jt, js, tt, ts = _pair(tmp_path, emb_trainable)
    jblock, n_steps = jt.train_block()
    steps = jt.steps_per_domain()
    jdn, _ = jfused.make_fused_mamdr(jt.train_step_fn(), js.mask, "plus", n_steps, BATCH, 0,
                                     shuffle=False, steps_list=steps)
    frozen = jtrees.named_tree_map(
        lambda n, x: (not emb_trainable) and ("user_emb" in n or "item_emb" in n),
        jt.state.params)
    sub_step, to_sub, combine = jax_make_subset_train_step(
        jt.model, jt.tx, jt.step_cfg, frozen, jt.state.params)
    jdr = jfused.make_fused_dr_parallel(sub_step, to_sub, combine, js.mask, "plus", n_steps,
                                        BATCH, shuffle=False, steps_list=steps,
                                        lane_chunk=chunk)
    # DR starts after a DN phase: non-zero slots and step counter
    jstate, jshared, _ = jdn(jt.state, js.shared, jblock, ORDER, jax.random.PRNGKey(0), 0.1)
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
    tblock, tdr = _port_lanes(tt, ts, chunk)
    tstate, tstack = tdr(entry, tshared, ts._spec_stack, tblock, ORDER, AUX, tt.gen, 0.1)

    tsteps = tt.steps_per_domain()
    assert int(tstate.step) == int(entry.step) + sum(
        tsteps[s] + tsteps[ORDER[-1]] for s in AUX[-1])  # the last lane's
    _states_close(tstate, jstate)
    _trees_close(tstack, jstack, "specific stack")
    if not emb_trainable:
        assert (tstate.params["model"]["embedding"]["user_emb"]
                is ts.shared["model"]["embedding"]["user_emb"])


@pytest.mark.parametrize("chunk", [2, 3])
@pytest.mark.parametrize("emb_trainable", [False, True])
def test_chunked_lanes_equal_whole_lanes(tmp_path, emb_trainable, chunk):
    """Shuffles on and dropout 0.5: every lane's inputs are the whole
    dispatch's, so the groups give the same bits."""
    _, tcfg = _configs(tmp_path, emb_trainable)
    tcfg.model.dropout = 0.5
    _, tds = _datasets(long_tail=True, n_domain=N_DOMAIN)
    tt = Trainer(tcfg, tds, device="cpu")
    ts = MAMDRStrategy(tt)
    ts.prepare_fused()
    state0, gen0 = tt.state, tt.gen.get_state()
    out = {}
    for c in (0, chunk):
        tt.gen.set_state(gen0)
        block, dr = _port_lanes(tt, ts, c, shuffle=True)
        out[c] = dr(state0, ts.shared, ts._spec_stack, block, ORDER, AUX, tt.gen, 0.1)
        out[c] += (tt.gen.get_state(),)
    (w_state, w_stack, w_gen), (c_state, c_stack, c_gen) = out[0], out[chunk]
    assert torch.equal(w_gen, c_gen)  # the same draws
    assert int(w_state.step) == int(c_state.step) and w_state.seed == c_state.seed
    for a, b in zip(trees.leaves(w_state.params) + trees.leaves(w_stack),
                    trees.leaves(c_state.params) + trees.leaves(c_stack)):
        assert torch.equal(a, b)
    for a, b in zip(w_state.opt_state, c_state.opt_state):
        assert torch.equal(a, b)
    moved = w_stack["model"]["embedding"]["domain_emb"] != ts._spec_stack["model"][
        "embedding"]["domain_emb"]
    assert bool(moved.any(dim=(1, 2)).all())  # every domain's specific moved


def _strategy(tmp_path, n_domain, emb_trainable=True, **train):
    _, tcfg = _configs(tmp_path, emb_trainable, **train)
    _, tds = _datasets(long_tail=False, n_domain=n_domain)
    s = MAMDRStrategy(Trainer(tcfg, tds, device="cpu"))
    s.prepare_fused()
    return s


@pytest.mark.parametrize("n_domain,emb_trainable,train,want", [
    (9, True, {}, 7),                      # auto: trainable tables, d > 7
    (4, True, {}, 0),                      # a narrow fan stays whole
    (9, True, {"dr_lane_chunk": 3}, 3),    # the explicit knob wins
    (9, False, {}, 0),                     # frozen tables: the lanes hold no table
    (9, True, {"dr_parallel": "off"}, 0),  # no lanes, no groups
])
def test_lane_chunk_rule(tmp_path, n_domain, emb_trainable, train, want):
    s = _strategy(tmp_path, n_domain, emb_trainable, **train)
    assert s.dr_lanes == (train.get("dr_parallel") != "off")
    assert s._dr_lane_chunk_effective == want


def test_memory_gate_counts_the_lanes_of_a_group(tmp_path, monkeypatch):
    """On the card the gate admits the lanes when 3 x lanes x trainable bytes
    stay under 40% of free memory; a group of C counts C lanes."""
    s = _strategy(tmp_path, 9, dr_parallel="auto")
    trainable = sum(x.numel() * 4 for x in trees.leaves(s.trainer.state.params))
    free = 3 * 5 * trainable / 0.4  # room for 5 lanes, not 9
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device: (free + 1, free + 1))
    monkeypatch.setattr(s.trainer, "device", torch.device("cuda"))
    assert not s._dr_parallel_eligible()
    s.tc.dr_lane_chunk = 4
    assert s._dr_parallel_eligible()
