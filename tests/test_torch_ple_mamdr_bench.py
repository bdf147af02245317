"""PLE under MAMDR, the port against the benchmark's plain reference
(``portbench/reference/ple_mamdr.py``) at a tiny size on the CPU, through
the port's public entry points (``benchmark_config``, ``Trainer``,
``MAMDRStrategy``, the train steps) and the reference's (``Problem``,
``Reference``: its equations, dropout masks and Adam step of a lane):

- PLE's logits and every leaf's gradient (the other domains' zeros too) on
  seeded random weights;
- one DN Adam step, and one lane-step of three DR lanes from a state with
  Adam slots;
- PLE's spans (``ple.experts``, ``ple.gates``, ``ple.towers``) in the
  operator's trace, under the lane step's ``vmap`` too, and its counters
  ``ple.expert_rows`` / ``ple.expert_rows_used`` against a hand count
  (equal: whole leaves compute only the batch's task's last level).

The benchmark's cell (its comparison, controls, planted faults and work
count) is tested with the benchmark, in ``portbench/tests``.
"""

import json

import pytest
import torch

from portbench.reference import hashdrop
from portbench.reference.mamdr_mlp import Problem
from portbench.reference.ple_mamdr import TABLES, Reference

N_DOMAIN, DIM, BATCH, IDS = 4, 8, 32, 200
EXPERT, TOWER = [16, 8], [8]
# a leaf's gap after one step, over the step's size: an element whose Adam
# moment nearly cancels its gradient carries the gradient's rounding
STEP_GAP = 1e-2


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread: the ops are tiny, and the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(tmp_path, biases=False):
    """(trainer, strategy) of Amazon-13's ``ple_meta_mamdr_finetune`` at
    the tiny widths on a synthetic dataset; ``biases`` draws the biases
    (zeros otherwise)."""
    from mamdr_tpu_torch.benchmarks import benchmark_config
    from mamdr_tpu_torch.data.synthetic import make_synthetic_dataset
    from mamdr_tpu_torch.strategies.mamdr import MAMDRStrategy
    from mamdr_tpu_torch.train.trainer import Trainer

    econf = benchmark_config("Amazon_13", "ple_meta_mamdr_finetune")
    m, tc = econf.model, econf.train
    m.user_dim = m.item_dim = m.domain_dim = DIM
    m.hidden_dim, m.tower_hidden_dim = list(EXPERT), list(TOWER)
    econf.dataset.batch_size = BATCH
    tc.checkpoint_path = tc.result_save_path = str(tmp_path)
    tc.metrics_jsonl = False
    ds = make_synthetic_dataset(n_domain=N_DOMAIN, n_uid=IDS, n_pid=IDS, n_per_domain=4 * BATCH,
                                seed=7, batch_size=BATCH)
    t = Trainer(econf, ds, device="cpu", verbose=False)
    if biases:
        g = torch.Generator().manual_seed(5)
        for n, x in _leaves(t.state.params).items():
            if "bias" in n:
                x.copy_(torch.randn(x.shape, generator=g) * 0.1)
    return t, MAMDRStrategy(t)


def _leaves(params):
    """The port's model leaves by the reference's names (the last part of
    each path)."""
    from mamdr_tpu_torch.utils import trees

    return {path.split("/")[-1]: x for path, x in trees.leaves_with_names(params["model"])}


def _slots(t, flat):
    """A flat Adam slot vector of the port's trainable leaves, by name."""
    from mamdr_tpu_torch.utils import trees

    out, off = {}, 0
    for (path, x), m in zip(trees.leaves_with_names(t.state.params), trees.leaves(t.tx.mask)):
        if m:
            out[path.split("/")[-1]] = flat[off:off + x.numel()].view(x.shape)
            off += x.numel()
    return out


def _reference(t) -> Reference:
    """The reference over the port's start leaves and settings."""
    shared0 = {n: x.detach().clone() for n, x in _leaves(t.state.params).items()}
    ids = torch.arange(BATCH)
    train = [(ids, ids, torch.zeros(BATCH)) for _ in range(N_DOMAIN)]
    tc = t.config.train
    prob = Problem(train=train, frozen={}, shared0=shared0, specific0=[], hidden=tuple(TOWER),
                   dropout=t.config.model.dropout, lr=tc.learning_rate,
                   meta_lr=tc.meta_learning_rate, sample_num=tc.sample_num,
                   add_query=tc.add_query_domain, shuffle_sequence=tc.shuffle_sequence,
                   reg_step=tc.domain_regulation_step, batch=BATCH, l2=t.step_cfg.l2_emb,
                   np_seed=0, shuffle_seed=0, dropout_seed=0)
    return Reference(prob)


def _batch(dom: int, seed: int, weight_holes: bool = False):
    """A batch of domain ``dom``: random ids and labels, weight 1 (every
    fifth row 0 with ``weight_holes``)."""
    g = torch.Generator().manual_seed(seed)
    w = torch.ones(BATCH)
    if weight_holes:
        w = w * (torch.arange(BATCH) % 5 != 0).to(w.dtype)
    return {"uid": torch.randint(0, IDS, (BATCH,), generator=g, dtype=torch.int32),
            "pid": torch.randint(0, IDS, (BATCH,), generator=g, dtype=torch.int32),
            "domain": torch.full((BATCH,), dom, dtype=torch.int32),
            "label": torch.randint(0, 2, (BATCH,), generator=g).to(torch.float32), "weight": w}


def _whole(leaves):
    """Every table's rows, as the reference's pieces name them."""
    return {n: torch.arange(leaves[n].shape[0]) for n in TABLES}


def _ref_step(ref, pre, batch, seeds):
    """The reference's pieces after one step of ``batch`` from the pieces
    ``pre`` under the dropout ``seeds``: its equations' gradients, then
    its lane step (tables, l2, Adam)."""
    dom, rows = int(batch["domain"][0]), _whole(pre["p"])
    uid, pid = batch["uid"].long(), batch["pid"].long()
    x = ref.lane_fields(pre["p"], rows, uid, pid, dom)
    drop = [m[0] for m in ref.drop_masks(dom, [seeds])]
    dense = {n: pre["p"][n] for n in ref.tower_names}
    _, dx, grads = ref.grads(dense, x, batch["label"], batch["weight"], dom, drop)
    return ref.lane_step(pre, rows, dx, [grads[n] for n in ref.tower_names], uid, pid, dom,
                         batch["weight"])


def _rel(a, b):
    return float(torch.linalg.vector_norm((a - b).double())
                 / max(float(torch.linalg.vector_norm(b.double())), 1e-30))


def test_logits_and_every_gradient_match_the_reference(tmp_path):
    from mamdr_tpu_torch.ops.fast_random import step_seeds
    from mamdr_tpu_torch.train.steps import make_autograd_loss_grad

    t, _ = _port(tmp_path, biases=True)
    ref, dom = _reference(t), 2
    batch = _batch(dom, 11, weight_holes=True)
    params, start = t.state.params, _leaves(t.state.params)
    seeds = step_seeds(12345, torch.tensor(3), t.model.n_dropout_sites)
    logits = t.model.apply(params["model"], batch["uid"], batch["pid"], batch["domain"], seeds)
    uid, pid = batch["uid"].long(), batch["pid"].long()
    x = ref.lane_fields(start, _whole(start), uid, pid, dom)
    drop = [m[0] for m in ref.drop_masks(dom, [[int(s) for s in seeds]])]
    dense = {n: start[n] for n in ref.tower_names}
    torch.testing.assert_close(logits, ref.logits(dense, x, dom, drop), rtol=1e-5, atol=1e-6)

    loss, grads = make_autograd_loss_grad(t.model, t.step_cfg)(params, batch, seeds)
    rloss, dx, rgrads = ref.grads(dense, x, batch["label"], batch["weight"], dom, drop)
    torch.testing.assert_close(loss, rloss, rtol=1e-6, atol=0)
    l2 = t.step_cfg.l2_emb
    for f, (name, ids) in enumerate((("user_emb", uid), ("item_emb", pid))):
        rgrads[name] = torch.zeros_like(start[name]).index_add_(
            0, ids, dx[:, f * DIM:(f + 1) * DIM])
    rgrads["domain_emb"] = torch.zeros_like(start["domain_emb"])
    rgrads["domain_emb"][dom] = dx[:, 2 * DIM:].sum(0)
    for name in TABLES:
        rgrads[name] = rgrads[name] + 2.0 * l2 * start[name]
    got = _leaves(grads)
    assert set(rgrads) == set(got) == set(ref.names)
    for n, r in rgrads.items():
        assert _rel(got[n], r) < 2e-5, n
        if n.startswith(("task_", "tower_")):  # the other domains' parts: zeros
            others = [k for k in range(r.shape[0]) if k != dom]
            assert not got[n][others].any() and not r[others].any(), n
    assert not got["shared_gate_kernel_0"].any()


def _compare(ref, start, post, want, label):
    """The port's lane after a step (leaves, slots by leaf, count) against
    the reference's pieces after the same step from ``start``."""
    p, mu, nu, count = post
    assert int(count) == want["count"], label
    for n in ref.names:
        step = float(torch.linalg.vector_norm((want["p"][n] - start[n]).double()))
        gap = float(torch.linalg.vector_norm((p[n] - want["p"][n]).double()))
        assert gap <= STEP_GAP * step, (label, n)
        assert _rel(mu[n], want["mu"][n]) < 1e-5, (label, n)
        assert _rel(nu[n], want["nu"][n]) < 1e-5, (label, n)


def test_one_dn_step_and_one_dr_lane_step_match_the_reference(tmp_path):
    from mamdr_tpu_torch.train import fused
    from mamdr_tpu_torch.train.steps import make_subset_train_step

    t, strat = _port(tmp_path)
    ref, n_layers = _reference(t), t.model.n_dropout_sites
    state = t.state
    base = int(state.seed)
    start = {n: x.detach().clone() for n, x in _leaves(state.params).items()}

    # one DN step of domain 1 from the start
    batch = _batch(1, 21)
    new, _ = t.train_step_fn()(state, batch)
    pre = {"count": 0, "p": start, "mu": {n: torch.zeros_like(x) for n, x in start.items()}}
    pre["nu"] = pre["mu"]
    want = _ref_step(ref, pre, batch, hashdrop.step_seeds(base, 0, n_layers))
    _compare(ref, start, (_leaves(new.params), _slots(t, new.opt_state.mu),
                          _slots(t, new.opt_state.nu), new.opt_state.count), want, "dn")

    # three DR lanes (domains 0, 1, 3) from the state after it, slots and all
    doms = [0, 1, 3]
    sub_step, to_sub, _ = make_subset_train_step(t.model, t.tx, t.step_cfg, t.frozen_mask(),
                                                 new.params)
    lanes = fused.make_lane_state(new, to_sub(new.params), strat.mask, len(doms))
    cols = [_batch(d, 30 + d) for d in doms]
    out, _ = sub_step(lanes, {c: torch.stack([b[c] for b in cols]) for c in cols[0]})
    start = {n: x.detach().clone() for n, x in _leaves(new.params).items()}
    pre = {"count": 1, "p": start, "mu": _slots(t, new.opt_state.mu),
           "nu": _slots(t, new.opt_state.nu)}
    bases = hashdrop.lane_seeds(base, len(doms))
    for l, b in enumerate(cols):
        want = _ref_step(ref, pre, b, hashdrop.step_seeds(bases[l], 1, n_layers))
        leaves = {n: x[l] for n, x in _leaves(out.params).items()}
        _compare(ref, start, (leaves, _slots(t, out.opt_state.mu[l]),
                              _slots(t, out.opt_state.nu[l]), out.opt_state.count[l]),
                 want, f"lane {l}")


def test_spans_and_counters(tmp_path):
    from mamdr_tpu_torch.train import fused
    from mamdr_tpu_torch.train.steps import make_subset_train_step
    from mamdr_tpu_torch.utils import trace

    t, strat = _port(tmp_path)
    cfg = t.config.model
    # whole task leaves: one level, computed for the batch's task alone, so
    # the experts computed are the experts the head uses
    computed = used = cfg.specific_expert_num + cfg.shared_expert_num
    batch = _batch(1, 41)
    sub_step, to_sub, _ = make_subset_train_step(t.model, t.tx, t.step_cfg, t.frozen_mask(),
                                                 t.state.params)
    lanes = fused.make_lane_state(t.state, to_sub(t.state.params), strat.mask, 3)
    lane_batch = {c: torch.stack([_batch(d, 50 + d)[c] for d in (0, 2, 3)]) for c in batch}
    step = t.train_step_fn()

    before = trace.counters()
    step(t.state, batch)
    got = trace.since(before)
    assert (got["ple.expert_rows"], got["ple.expert_rows_used"]) == (BATCH * computed,
                                                                     BATCH * used)
    before = trace.counters()
    off = sub_step(lanes, lane_batch)
    got = trace.since(before)
    assert (got["ple.expert_rows"], got["ple.expert_rows_used"]) == (3 * BATCH * computed,
                                                                     3 * BATCH * used)

    logged = []
    with trace.profiled(str(tmp_path / "prof"), "ple", logged.append):
        step(t.state, batch)
        on = sub_step(lanes, lane_batch)
    with open(tmp_path / "prof" / "ple.trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"ple.experts", "ple.gates", "ple.towers", "step.loss_grad"} <= names
    assert logged[0]["ple.expert_rows"] == 4 * BATCH * computed
    assert torch.equal(on[1], off[1])
    assert all(torch.equal(a, c) for a, c in zip(on[0].opt_state, off[0].opt_state))
