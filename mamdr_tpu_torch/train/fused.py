"""Whole training and evaluation phases over a device-resident data block.

Counterpart of ``mamdr_tpu/train/fused.py`` (block stacking, batch
formation, the ragged sequential pass with its step cap,
``make_fused_passes``, ``make_fused_dn``, ``make_fused_reptile``,
``_grad_epoch_on_flat``, ``make_fused_maml``, ``make_fused_pcgrad``,
``make_fused_mamdr``,
``make_fused_dr_parallel`` with its lane chunks and its lanes split over
the data group of a mesh, ``stack_specific`` / ``unstack_specific``, the
fused evals — on a mesh each data rank evaluating its share of the domains
— and ``make_fused_separate``):

  - all domain data lives on the device once, padded to a uniform
    [n_domain, n_steps*batch] block (weight-0 tail rows);
  - epoch shuffling happens on the device: a random-key sort that keeps the
    pad tail last, then ONE gather of all 32-bit columns packed together;
  - the sequential multi-domain pass runs only each domain's ceil(n_d/B)
    real steps (the JAX package's ragged pass, :161-242). A padded step
    would be an all-pad batch, which the train step turns into an exact
    no-op, so skipping it is bit-identical to the padded scan;
  - the meta strategies' accumulators (MAML, MLDG, PCGrad) sum gradients at
    fixed params over a domain's real batches (``_grad_epoch_on_flat``) and
    hold only the meta mask's leaves, ``None`` elsewhere, so a frozen table
    is never copied; the meta optimizer is the flat Adam over that mask;
  - the Domain-Regularization phase runs every query domain as a LANE: all
    lanes start from the DR-entry state and take each step together, one
    launch chain per lane-step through the lane-batched train step. Lanes
    with fewer real steps than the longest see all-pad batches, which the
    per-lane gate turns into exact no-ops. With a lane chunk C the lanes
    run in groups of C, one group after the other, with the same results;
  - evaluation runs every domain as a lane too, each lane with its own
    weights (``make_lane_eval``, the model's ``apply_lanes``): a lane-step
    evaluates a [D, B] batch, so a
    split takes S = max_d ceil(n_d/B) lane-steps, not sum_d ceil(n_d/B)
    calls. A short domain's trailing lane-steps are all-pad batches, which
    add exact zeros to its confusion counts and are left out of its mean
    loss, so the result is the JAX package's ragged scan's
    (``_make_ragged_eval``). The finetune stage trains its domains as lanes
    through the same lane-batched train step the DR phase uses
    (``make_fused_separate``);
  - a model's batch statistics (STAR's norms, ``TrainState.batch_stats``)
    ride in the state: every sequential pass chains them through its steps,
    domains and query runs, as the JAX package's scans carry them; the
    accumulators read the state's at fixed params; the evals take one tree
    every lane reads (each lane its own domain's row), the finetune lanes an
    [L]-stacked one. The DR lanes would keep only one lane's statistics, so
    they refuse a state that has any.

The JAX package fuses each phase into one jit dispatch; here a phase is a
Python loop issuing work to one CUDA stream, and nothing in it waits for the
device: shuffle keys come from a generator on the device, per-domain losses
stay on the device, and the caller reads them once at the end.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mamdr_tpu_torch.data.dataset import DomainSplit
from mamdr_tpu_torch.metrics.auc import auc_init, auc_result, auc_update
from mamdr_tpu_torch.ops.fast_random import dropout_mask, lane_seeds
from mamdr_tpu_torch.parallel.data_feed import process_local_rows
from mamdr_tpu_torch.parallel.mesh import DATA_AXIS, all_reduce_sum_, broadcast
from mamdr_tpu_torch.strategies import ops
from mamdr_tpu_torch.train.flat_optimizer import true_on
from mamdr_tpu_torch.train.state import TrainState
from mamdr_tpu_torch.train.steps import (field_gather, make_l2_term, model_logits,
                                          uncertainty_loss, weighted_bce)
from mamdr_tpu_torch.utils import trace, trees

Tree = Any


def stack_domains_on_device(
    splits: List[DomainSplit], batch_size: int, device
) -> Tuple[Dict[str, torch.Tensor], int]:
    """Pack all domains into one device-resident block.

    Returns ({col: [D, N_pad]}, n_steps) with N_pad = max_steps*batch over
    domains; short domains wrap-around-pad with weight-0 rows.
    """
    d = len(splits)
    max_n = max(s.n for s in splits)
    n_steps = -(-max_n // batch_size)
    n_pad = n_steps * batch_size
    cols = {k: np.empty((d, n_pad), np.int32) for k in ("uid", "pid", "domain")}
    cols["label"] = np.empty((d, n_pad), np.float32)
    cols["weight"] = np.zeros((d, n_pad), np.float32)
    for i, s in enumerate(splits):
        idx = np.arange(n_pad) % s.n
        cols["uid"][i] = s.uid[idx]
        cols["pid"][i] = s.pid[idx]
        cols["domain"][i] = s.domain[idx]
        cols["label"][i] = s.label[idx]
        cols["weight"][i, : s.n] = 1.0
    return {k: torch.from_numpy(v).to(device) for k, v in cols.items()}, n_steps


def domain_step_counts(splits: List[DomainSplit], batch_size: int) -> List[int]:
    """Static per-domain real step counts ceil(n_d / B)."""
    return [-(-s.n // batch_size) for s in splits]


def _form_batches(flat: Dict[str, torch.Tensor], gen: torch.Generator,
                  n_steps: int, batch: int, cap_steps: int = 0,
                  shuffle: bool = True,
                  keys: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Shuffled batches from a column block, formed by ONE gather: columns
    [N_pad] give [steps, B] batches; columns [L, N_pad] (one row block per
    lane) give [steps, L, B], each lane shuffled on its own by one draw of
    shape [L, N_pad] — or by ``keys``, that draw made beforehand (the
    chunked DR lanes draw every epoch's keys for all lanes first).

    The shuffle permutes only the real rows and keeps the weight-0 pad tail
    last (stable sort by random key + pad penalty), so a domain trains
    exactly ceil(n_d/B) effective steps. All columns are 32-bit: they are
    packed into one [..., N_pad, C] int32 array (float columns reinterpreted,
    a bit-exact round trip) and gathered once. Each returned column is
    contiguous, so a step's slice is a contiguous [B] or [L, B] block.
    """
    n_pad = n_steps * batch
    w = flat["weight"]
    if shuffle:
        if keys is None:
            keys = torch.rand(w.shape, generator=gen, device=w.device)
        sort_key = keys + torch.where(w > 0.0, 0.0, 2.0)
        perm = torch.argsort(sort_key, dim=-1, stable=True)
    else:
        # equivalence testing: natural order, pad tail last
        perm = torch.arange(n_pad, device=w.device).expand(w.shape)
    steps = n_steps if cap_steps <= 0 else min(cap_steps, n_steps)
    idx = perm[..., : steps * batch]
    keys = sorted(flat)
    packed = torch.stack(
        [flat[k] if flat[k].dtype == torch.int32 else flat[k].view(torch.int32)
         for k in keys],
        dim=-1,
    )
    # [..., steps*B, C]
    rows = torch.gather(packed, -2, idx[..., None].expand(*idx.shape, len(keys)))
    out = {}
    for j, k in enumerate(keys):
        col = rows[..., j].reshape(*w.shape[:-1], steps, batch)
        col = col.movedim(-2, 0).contiguous()  # the step axis first
        if flat[k].dtype != torch.int32:
            col = col.view(flat[k].dtype)
        out[k] = col
    return out


def _steps_run(n_steps: int, cap_steps: int = 0, real_steps: Optional[int] = None) -> int:
    """The steps an epoch runs: ``n_steps``, at most ``cap_steps`` when that
    is positive, at most ``real_steps`` when given."""
    steps = n_steps if cap_steps <= 0 else min(cap_steps, n_steps)
    return steps if real_steps is None else min(steps, int(real_steps))


def _count_dr(steps: int, lane_steps: Sequence[Optional[int]]) -> None:
    """Counts a DR epoch of ``steps`` lane-steps whose lanes hold
    ``lane_steps`` real steps each (None: not known): ``lane_steps.dr``,
    ``lane_slots.dr`` (lanes x lane-steps) and ``pad_lane_slots.dr`` (the
    lane slots whose batch is all padding). A sequential DR step is a
    lane-step of one lane."""
    trace.count("lane_steps.dr", steps)
    trace.count("lane_slots.dr", steps * len(lane_steps))
    trace.count("pad_lane_slots.dr",
                sum(steps - min(steps, r) for r in lane_steps if r is not None))


def _epoch_on_flat(train_step, state: TrainState, flat, gen: torch.Generator,
                   n_steps: int, batch: int, cap_steps: int = 0,
                   shuffle: bool = True, real_steps: Optional[int] = None,
                   keys: Optional[torch.Tensor] = None):
    """One shuffled epoch over a flat column block (JAX ``_epoch_on_flat``,
    fused.py:121-153): at most ``cap_steps`` steps when that is positive, and
    only the first ``real_steps`` of them when given — the rest would be
    all-pad batches (real rows sort first), which the train step turns into
    exact no-ops, so not running them is bit-identical.

    ``flat`` columns are [N_pad], or [L, N_pad] with a lane-batched
    ``train_step`` (then ``real_steps`` is the largest over the lanes);
    ``keys``: the shuffle's random sort keys, drawn beforehand
    (``_form_batches``). Returns (state, the mean data loss over the steps
    run)."""
    steps = _steps_run(n_steps, cap_steps, real_steps)
    with trace.span("engine.shuffle"):
        batches = _form_batches(flat, gen, n_steps, batch, cap_steps=steps, shuffle=shuffle,
                                keys=keys)
    loss_sum = torch.zeros((), dtype=torch.float32, device=flat["weight"].device)
    for s in range(steps):
        state, loss = train_step(state, {k: v[s] for k, v in batches.items()})
        loss_sum = loss_sum + loss
    return state, loss_sum / max(steps, 1)


def _sequential_pass(train_step, state: TrainState, block, order: Sequence[int],
                     gen: torch.Generator, steps_of: Optional[Sequence[int]],
                     n_steps: int, batch: int, shuffle: bool = True, cap_steps: int = 0):
    """One epoch on each domain in `order`, chained without reset, running
    only each domain's real steps (`steps_of`, when given), at most
    `cap_steps` of them when that is positive (the JAX package's
    ``_make_sequential_pass`` / ``_ragged_pass``, fused.py:161-242, 508-546).
    Returns (state, [D] losses on the device): losses[i] is the mean data
    loss over the steps run of the domain at order position i."""
    losses = []
    for dom in order:
        dom = int(dom)
        state, loss = _epoch_on_flat(
            train_step, state, {k: v[dom] for k, v in block.items()}, gen, n_steps,
            batch, cap_steps=cap_steps, shuffle=shuffle,
            real_steps=None if steps_of is None else steps_of[dom])
        losses.append(loss)
    return state, torch.stack(losses)


def make_fused_passes(train_step, n_steps: int, batch: int,
                      steps_list: Optional[Sequence[int]] = None, shuffle: bool = True):
    """The joint loop's epoch (JAX ``make_fused_passes``, fused.py:549-563):
    sequential_pass(state, block, order, gen) -> (state, [D] losses), one
    epoch on each domain in `order` chained without reset, only real steps
    run (`steps_list`)."""
    steps_of = None if steps_list is None else [int(s) for s in steps_list]

    def sequential_pass(state: TrainState, block, order, gen: torch.Generator):
        return _sequential_pass(train_step, state, block, order, gen, steps_of, n_steps,
                                batch, shuffle)

    return sequential_pass


def make_fused_dn(train_step, mask, n_steps: int, batch: int, cap_steps: int = 0,
                  shuffle: bool = True, steps_list: Optional[Sequence[int]] = None):
    """The Domain-Negotiation epoch (reference domain_negotiation.py:49-88;
    JAX ``make_fused_dn``, fused.py:858-883): load meta once, chain through
    `order` without reset (each domain's epoch at most `cap_steps` steps; 0:
    whole), then meta += (θ_final - meta) * meta_lr and load meta again.

    dn_epoch(state, meta, block, order, gen, meta_lr) -> (state, meta, [D]
    losses)."""
    steps_of = None if steps_list is None else [int(s) for s in steps_list]

    def dn_epoch(state: TrainState, meta, block, order, gen, meta_lr):
        state = state.replace(params=ops.load_masked(state.params, meta, mask))
        state, losses = _sequential_pass(train_step, state, block, order, gen, steps_of,
                                         n_steps, batch, shuffle, cap_steps)
        meta = ops.reptile_update(meta, state.params, meta_lr, mask)
        state = state.replace(params=ops.load_masked(state.params, meta, mask))
        return state, meta, losses

    return dn_epoch


def make_fused_reptile(train_step, mask, n_steps: int, batch: int, batch_mode: bool,
                       cap_steps: int = 0, shuffle: bool = True,
                       steps_list: Optional[Sequence[int]] = None):
    """The Reptile epoch (reference reptile.py:44-90; JAX
    ``make_fused_reptile``, fused.py:806-855). Per domain in `order`: load
    meta, an epoch of at most `cap_steps` steps (0: whole), then meta +=
    (adapted - meta) * meta_lr, or under `batch_mode` acc += adapted - meta
    with one meta += acc * meta_lr at the epoch's end. Only the params are
    reloaded from meta: the optimizer slots and step count carry on across
    domains (the reference's SetVarOp assigns weights only). The
    accumulator holds the masked leaves; its other leaves are meta's, passed
    through unread. Ends with meta loaded.

    reptile_epoch(state, meta, block, order, gen, meta_lr) -> (state, meta,
    [D] losses)."""
    steps_of = None if steps_list is None else [int(s) for s in steps_list]

    def reptile_epoch(state: TrainState, meta, block, order, gen, meta_lr):
        acc = trees.tree_map(lambda m, x: torch.zeros_like(x) if m else x, mask, meta)
        losses = []
        for dom in order:
            dom = int(dom)
            state = state.replace(params=ops.load_masked(state.params, meta, mask))
            state, loss = _epoch_on_flat(
                train_step, state, {k: v[dom] for k, v in block.items()}, gen, n_steps,
                batch, cap_steps=cap_steps, shuffle=shuffle,
                real_steps=None if steps_of is None else steps_of[dom])
            losses.append(loss)
            if batch_mode:
                acc = ops.delta_accumulate(acc, state.params, meta, mask)
            else:
                meta = ops.reptile_update(meta, state.params, meta_lr, mask)
        if batch_mode:
            meta = ops.scaled_add(meta, acc, meta_lr, mask)
        state = state.replace(params=ops.load_masked(state.params, meta, mask))
        return state, meta, torch.stack(losses)

    return reptile_epoch


ACCUMULATE_MODES = ("sum", "ema", "drop")
DROP_RATE = 0.2  # average_meta_grad "drop": Dropout(0.2) on 1-D gradients


def accumulate_grads(acc, grads, mask, accumulate: str, drop_seed: Optional[int] = None):
    """acc with one batch's gradients added (JAX ``grad_epoch``'s step,
    steps.py:307-324): "sum" adds them, "ema" takes acc*0.999 + g*0.001,
    "drop" adds them after inverted dropout of every 1-D gradient leaf (each
    element kept with p = 0.8 and scaled by 1/0.8, the others 0; leaves of
    higher rank untouched). The drop masks are hash masks
    (``fast_random.dropout_mask``) seeded from ``drop_seed``, one seed a leaf
    made on the device (``lane_seeds``): the same on the card and the CPU,
    and nothing read back. jax.random's stream is not reproduced. Only the
    leaves ``mask`` marks accumulate; ``acc`` holds ``None`` at the others."""
    if accumulate == "ema":
        return ops.ema_accumulate(acc, grads, mask)
    if accumulate == "drop":
        if drop_seed is None:
            raise ValueError('accumulate "drop" needs a drop_seed')
        pairs = [(a, g) for a, g in zip(trees.leaves(acc), trees.leaves(grads))
                 if a is not None and g.dim() == 1]
        seeds = iter(lane_seeds(drop_seed, len(pairs), pairs[0][1].device)) if pairs else None

        def drop(a, g):
            if a is None or g.dim() != 1:
                return g
            keep = dropout_mask(next(seeds), DROP_RATE, g.shape)
            return torch.where(keep, g / (1.0 - DROP_RATE), 0.0)

        grads = trees.tree_map(drop, acc, grads)
    return ops.tree_add_trees(acc, grads)


def grad_epoch(grad_fn, params, stacked, acc, mask, accumulate: str = "sum", stats=None,
               gate: bool = False, drop_seeds: Optional[Callable[[], int]] = None):
    """Accumulate the gradients of every [B] batch of ``stacked`` ({col: [S,
    B]}) at fixed params into ``acc`` (JAX ``grad_epoch``, steps.py:295-340):
    ``grad_fn(params, batch, stats)`` (``steps.make_accum_grad_fn``), then
    ``accumulate_grads``; under "drop", ``drop_seeds()`` gives each batch's
    seed (a host int: ``Trainer.draw_seed``). With ``gate`` an all-pad batch
    leaves the accumulator untouched (a ``torch.where`` on the device)."""
    if accumulate not in ACCUMULATE_MODES:
        raise ValueError(f"unknown accumulate mode {accumulate!r}")
    for s in range(stacked["weight"].shape[0]):
        b = {k: v[s] for k, v in stacked.items()}
        seed = drop_seeds() if accumulate == "drop" else None
        new = accumulate_grads(acc, grad_fn(params, b, stats), mask, accumulate, seed)
        if gate:
            has_data = torch.sum(b["weight"]) > 0.0
            new = trees.tree_map(lambda n, a: None if a is None else torch.where(has_data, n, a),
                                 new, acc)
        acc = new
    return acc


def _grad_epoch_on_flat(grad_fn, params, flat, gen: torch.Generator, n_steps: int,
                        batch: int, acc, mask, accumulate: str = "sum", cap_steps: int = 0,
                        shuffle: bool = True, real_steps: Optional[int] = None, stats=None,
                        drop_seeds: Optional[Callable[[], int]] = None):
    """Accumulate the gradients of one shuffled epoch over a flat column
    block at fixed params (JAX ``_grad_epoch_on_flat``, fused.py:566-622):
    ``grad_epoch`` on at most ``cap_steps`` batches (0: all), only the first
    ``real_steps`` of them when given, with ``accumulate`` "sum", "ema" or
    "drop" (``accumulate_grads``, its seeds from ``drop_seeds``).

    The shuffle keeps the weight-0 pad tail last, so the batches run are the
    domain's real ones and the sum is that of its ceil(n/B) weighted means.
    An all-pad batch leaves the accumulator untouched (a gate on the device);
    with ``real_steps`` no run batch is all-pad (real rows sort first), so
    the gate is left out there."""
    if accumulate not in ACCUMULATE_MODES:
        raise ValueError(f"unknown accumulate mode {accumulate!r}")
    steps = _steps_run(n_steps, cap_steps, real_steps)
    with trace.span("engine.shuffle"):
        batches = _form_batches(flat, gen, n_steps, batch, cap_steps=steps, shuffle=shuffle)
    return grad_epoch(grad_fn, params, batches, acc, mask, accumulate, stats,
                      gate=real_steps is None, drop_seeds=drop_seeds)


def zeros_acc(mask, params):
    """A meta-gradient accumulator: zeros at the masked leaves, ``None`` at
    the others (no table-sized tensor for a leaf that never accumulates)."""
    return trees.tree_map(lambda m, x: torch.zeros_like(x) if m else None, mask, params)


def meta_step(meta_tx, target, opt, acc, mask, grad_scale: float):
    """target + the meta optimizer's step on acc * grad_scale (masked
    leaves; the others pass through by reference) -> (target, opt), by
    ``step`` (flat Adam on the card: one launch of K4)."""
    if grad_scale != 1.0:
        acc = trees.tree_map(lambda m, g: g * grad_scale if m else g, mask, acc)
    return meta_tx.step(target, acc, opt, true_on(opt.count.device))


def make_fused_maml(train_step, grad_fn, mask, meta_tx, n_steps_support: int,
                    n_steps_query: int, batch: int, batch_mode: bool, cap_steps: int = 0,
                    accumulate: str = "sum", mldg: bool = False, shuffle: bool = True,
                    steps_list_support: Optional[Sequence[int]] = None,
                    steps_list_query: Optional[Sequence[int]] = None):
    """The MAML or MLDG epoch (JAX ``make_fused_maml``, fused.py:625-729).

    MAML (maml.py:60-121), per domain in `order`: load meta's masked leaves;
    an inner epoch on the support block with the model's own optimizer
    (slots and step count carry on across domains); accumulate the query
    block's gradients at the adapted weights; then (per-domain mode) apply
    the meta optimizer at meta and clear, or under `batch_mode` once at the
    epoch's end.

    MLDG (mldg.py:92-119): the support gradients are accumulated at meta (no
    inner optimizer); a mid-stream meta step from the loaded weights gives
    the adapted ones — it advances the meta optimizer's moments and count
    and does NOT clear the accumulator — and the query gradients at the
    adapted weights join the same accumulator (g_support(θ) +
    g_query(θ')); the apply then follows as in MAML, at meta.

    ``meta_tx`` is the flat Adam over the meta mask; accumulators hold the
    masked leaves only, so frozen tables are never copied and come out as
    the same tensors. Ends with meta loaded.

    maml_epoch(state, meta, meta_opt, support_block, query_block, order, gen,
    grad_scale) -> (state, meta, meta_opt)."""
    sup_of = None if steps_list_support is None else [int(s) for s in steps_list_support]
    q_of = None if steps_list_query is None else [int(s) for s in steps_list_query]

    def maml_epoch(state: TrainState, meta, meta_opt, support_block, query_block, order,
                   gen, grad_scale: float):
        acc = zeros_acc(mask, meta)
        for dom in order:
            dom = int(dom)
            sup_flat = {k: v[dom] for k, v in support_block.items()}
            q_flat = {k: v[dom] for k, v in query_block.items()}
            sup_rs = None if sup_of is None else sup_of[dom]
            q_rs = None if q_of is None else q_of[dom]
            state = state.replace(params=ops.load_masked(state.params, meta, mask))
            if mldg:
                acc = _grad_epoch_on_flat(grad_fn, state.params, sup_flat, gen,
                                          n_steps_support, batch, acc, mask, accumulate,
                                          cap_steps, shuffle, real_steps=sup_rs,
                                          stats=state.batch_stats)
                adapted, meta_opt = meta_step(meta_tx, state.params, meta_opt, acc, mask,
                                              grad_scale)
                state = state.replace(params=adapted)
            else:
                state, _ = _epoch_on_flat(train_step, state, sup_flat, gen, n_steps_support,
                                          batch, cap_steps=cap_steps, shuffle=shuffle,
                                          real_steps=sup_rs)
            acc = _grad_epoch_on_flat(grad_fn, state.params, q_flat, gen, n_steps_query,
                                      batch, acc, mask, accumulate, cap_steps, shuffle,
                                      real_steps=q_rs, stats=state.batch_stats)
            if not batch_mode:
                meta, meta_opt = meta_step(meta_tx, meta, meta_opt, acc, mask, grad_scale)
                acc = zeros_acc(mask, meta)
        if batch_mode:
            meta, meta_opt = meta_step(meta_tx, meta, meta_opt, acc, mask, grad_scale)
        state = state.replace(params=ops.load_masked(state.params, meta, mask))
        return state, meta, meta_opt

    return maml_epoch


def make_fused_pcgrad(grad_fn, mask, meta_tx, n_steps: int, batch: int, cap_steps: int = 0,
                      mode: str = "reference", shuffle: bool = True,
                      steps_list: Optional[Sequence[int]] = None):
    """The PCGrad epoch (reference pcgrad.py:60-127; JAX
    ``make_fused_pcgrad``, fused.py:732-803). Per query domain q in `order`:
    accumulate q's gradients at the current weights (at most `cap_steps`
    batches); then for each of its aux domains accumulate a whole epoch's
    gradients and project them (``ops.pcgrad_project``) against the running
    sum in mode "reference" (the reference aliases ``final_grads`` to the
    query grads and projects in place) or against q's own gradients in mode
    "paper", adding each projection to the running sum; then one meta
    optimizer step on the sum (times `grad_scale`). The weights advance
    between query domains; the model's own optimizer and ``state.step``
    are never used. Accumulators hold the masked leaves only.

    pcgrad_epoch(state, meta_opt, block, order, aux, gen, grad_scale) ->
    (state, meta_opt); `order` [D] and `aux` [D, K] are host arrays."""
    steps_of = None if steps_list is None else [int(s) for s in steps_list]

    def real(dom: int) -> Optional[int]:
        return None if steps_of is None else steps_of[dom]

    def pcgrad_epoch(state: TrainState, meta_opt, block, order, aux, gen, grad_scale: float):
        for q, aux_q in zip(order, aux):
            q = int(q)
            params = state.params
            qg = _grad_epoch_on_flat(grad_fn, params, {k: v[q] for k, v in block.items()},
                                     gen, n_steps, batch, zeros_acc(mask, params), mask, "sum",
                                     cap_steps, shuffle, real_steps=real(q),
                                     stats=state.batch_stats)
            running = qg
            for a in aux_q:
                a = int(a)
                ag = _grad_epoch_on_flat(grad_fn, params, {k: v[a] for k, v in block.items()},
                                         gen, n_steps, batch, zeros_acc(mask, params), mask,
                                         "sum", 0, shuffle, real_steps=real(a),
                                         stats=state.batch_stats)
                proj = ops.pcgrad_project(running if mode == "reference" else qg, ag, mode)
                running = ops.tree_add_trees(running, proj)
            new_params, meta_opt = meta_step(meta_tx, params, meta_opt, running, mask,
                                             grad_scale)
            state = state.replace(params=new_params)
        return state, meta_opt

    return pcgrad_epoch


def make_fused_mamdr(train_step, mask, merged_method: str, n_steps: int, batch: int,
                     domain_regulation_step: int = 0, shuffle: bool = True,
                     steps_list: Optional[Sequence[int]] = None):
    """The full MAMDR epoch as two phase functions (reference mamdr.py:41-108;
    JAX fused.make_fused_mamdr, :886-986). Returns (dn_phase, dr_phase).

    dn_phase(state, shared, block, order, gen, meta_lr) -> (state, shared,
    losses): load shared -> sequential pass over `order` -> shared +=
    (θ_end - shared) * meta_lr.

    dr_phase(state, shared, specific_stack, block, order, aux, gen, meta_lr)
    -> (state, specific_stack), the sequential form: for each query domain q
    in `order`, for each support domain s in aux[q]: load merge(shared,
    specific[q]); a full epoch on s; an epoch on q of at most
    `domain_regulation_step` steps (0: whole); specific[q] += (θ - merged) *
    meta_lr. Optimizer slots and the step counter chain through the query
    domains. `order` [D] and `aux` [D, K] are host arrays; specific_stack
    carries a leading domain axis on masked leaves (stack_specific).
    """
    steps_of = None if steps_list is None else [int(s) for s in steps_list]

    def real(dom: int) -> Optional[int]:
        return None if steps_of is None else steps_of[dom]

    def dn_phase(state: TrainState, shared, block, order, gen, meta_lr):
        with trace.span("engine.merge"):
            state = state.replace(params=ops.load_masked(state.params, shared, mask))
        state, losses = _sequential_pass(
            train_step, state, block, order, gen, steps_of, n_steps, batch, shuffle)
        trace.count("steps.dn", sum(_steps_run(n_steps, 0, real(int(d))) for d in order))
        with trace.span("engine.reptile"):
            shared = ops.reptile_update(shared, state.params, meta_lr, mask)
        return state, shared, losses

    def dr_phase(state: TrainState, shared, specific_stack, block, order, aux, gen,
                 meta_lr):
        updated: Dict[int, Tree] = {}  # query domain -> its new specific tree
        for q, aux_q in zip(order, aux):
            q = int(q)
            spec_q = updated.get(q)
            if spec_q is None:
                spec_q = trees.tree_map(lambda m, s: s[q] if m else s, mask, specific_stack)
            query_flat = {k: v[q] for k, v in block.items()}
            for s_idx in aux_q:
                s_idx = int(s_idx)
                with trace.span("engine.merge"):
                    merged = ops.merge_weights(shared, spec_q, mask, merged_method)
                    state = state.replace(params=ops.load_masked(state.params, merged, mask))
                state, _ = _epoch_on_flat(
                    train_step, state, {k: v[s_idx] for k, v in block.items()}, gen,
                    n_steps, batch, shuffle=shuffle, real_steps=real(s_idx))
                state, _ = _epoch_on_flat(
                    train_step, state, query_flat, gen, n_steps, batch,
                    cap_steps=domain_regulation_step, shuffle=shuffle,
                    real_steps=real(q))
                _count_dr(_steps_run(n_steps, 0, real(s_idx))
                          + _steps_run(n_steps, domain_regulation_step, real(q)), [None])
                with trace.span("engine.specific_update"):
                    spec_q = ops.specific_update(spec_q, state.params, merged, meta_lr, mask)
            updated[q] = spec_q
        with trace.span("engine.write_back"):
            return state, _write_specific(specific_stack, mask, updated)

    return dn_phase, dr_phase


def _write_specific(specific_stack: Tree, mask: Tree, updated: Dict[int, Tree]) -> Tree:
    """A new stack with row q of every masked leaf replaced by updated[q]'s
    (one out-of-place index_copy per leaf)."""
    if not updated:
        return specific_stack
    doms = list(updated)
    leaves_of = [updated[q] for q in doms]

    def write(m, st, *new):
        if not m:
            return st
        at = torch.tensor(doms, dtype=torch.long, device=st.device)
        return st.index_copy(0, at, torch.stack(new))

    return trees.tree_map(write, mask, specific_stack, *leaves_of)


def make_lane_state(state: TrainState, sub_params: Tree, mask: Tree,
                    n_lanes: int, seeds: Optional[torch.Tensor] = None) -> TrainState:
    """`state` broadcast to n_lanes lanes: every lane starts from the same
    params (`sub_params`: state.params with scalar placeholders at frozen
    leaves, which get no lane axis), optimizer slots and
    step counter, each with its own dropout base seed: lane l's of
    ``lane_seeds``, or ``seeds[l]`` when given (a chunk of lanes passes its
    lanes' global seeds). Broadcasts are views where the first update
    replaces them anyway: the slots, the step, and the masked leaves
    (load_masked puts merged weights there before the first step); any other
    trainable leaf gets its own copy per lane."""
    def lanes_of(x):
        return x.expand(n_lanes, *x.shape)

    def param_lanes(m, x):
        if x.dim() == 0:  # a frozen leaf's placeholder
            return x
        return lanes_of(x) if m else lanes_of(x).contiguous()

    return state.replace(
        params=trees.tree_map(param_lanes, mask, sub_params),
        opt_state=type(state.opt_state)(*(lanes_of(x) for x in state.opt_state)),
        seed=lane_seeds(state.seed, n_lanes, state.step.device) if seeds is None else seeds,
        step=lanes_of(state.step),
    )


def make_fused_dr_parallel(sub_step, to_sub, combine, mask, merged_method: str,
                           n_steps: int, batch: int, domain_regulation_step: int = 0,
                           shuffle: bool = True,
                           steps_list: Optional[Sequence[int]] = None,
                           lane_chunk: int = 0, mesh=None):
    """The DR phase with every query domain as a lane (JAX
    fused.make_fused_dr_parallel, :989-1265).

    Query q's DR work only reads `shared` and the data block and writes
    specific[q], so the queries are independent once DN has fixed `shared`.
    Lane l handles query domain order[l]; every lane starts from the
    DR-entry params, optimizer slots and step counter (not from the previous
    query's, as the sequential dr_phase chains them) and gets its own
    dropout stream (fast_random.lane_seeds). The K support runs are the
    outer loop and all lanes take each step together through `sub_step`
    (steps.make_subset_train_step): 2*K epochs of lane-steps instead of
    D*2*K epochs of steps. With ragged `steps_list` an epoch runs the
    largest real step count over its lanes; shorter lanes' extra steps are
    all-pad batches, exact no-ops under the per-lane gate — bit-identical to
    skipping them. Nothing in the phase waits for the host.

    With ``lane_chunk`` C > 0 (and fewer than the d lanes) the lanes run in
    ⌈d/C⌉ groups of C, one after the other (the last group holds what is
    left), which bounds the lane state that exists at once to C lanes: the
    memory control for trainable tables, which every lane stacks. Every
    lane's inputs are the whole dispatch's: its entry state, its seed
    (``lane_seeds`` of its global index) and its shuffles — every epoch's
    random keys for all d lanes are drawn before the first group, in the
    order the whole dispatch draws them, and each group takes its rows — so
    a lane's results do not depend on C. The state returned is the last
    lane's (lane d-1, in the last group).

    Against dr_phase the results agree exactly when the inner optimizer has
    no slots and dropout is off; otherwise the slot and dropout lineages
    differ as described. The caller gates eligibility (MAMDRStrategy): the
    meta mask must cover every trainable leaf.

    On a ``mesh`` (parallel/mesh.py) the lanes of each group are split over
    the data group: data rank r of D runs lanes [r * C/D, (r + 1) * C/D) of
    a group of C (JAX ``lane_sharding``, :1033-1051; the caller makes D
    divide d and C). Every epoch's shuffle keys are then drawn for all d
    lanes first (as with groups), so a lane's inputs, seed and results do
    not depend on the rank that runs it. A trainable row-sharded table's
    lane copies keep the rank's rows, [C/D, rows/T, D] (the JAX
    ``P(data, table, None)``). After the last group the specific stack's
    rows are gathered over the data group (each domain's row from the rank
    that ran it, an exact zero-fill ``all_reduce``) and the last lane's
    state is broadcast from the last data rank.

    Returns dr_parallel with dr_phase's signature. A state with batch
    statistics is refused: they chain through the query domains in the
    sequential phase, and lanes would keep one lane's.
    """
    ranks, rank = (1, 0) if mesh is None else (mesh.data, mesh.data_index)
    steps_of = None if steps_list is None else [int(s) for s in steps_list]

    def longest(doms) -> Optional[int]:
        return None if steps_of is None else max(steps_of[int(d)] for d in doms)

    def count_epoch(doms, cap: int) -> None:
        """The counters of one lane epoch over ``doms``, a domain a lane."""
        _count_dr(_steps_run(n_steps, cap, longest(doms)),
                  [None if steps_of is None else steps_of[int(d)] for d in doms])

    def dr_parallel(state: TrainState, shared, specific_stack, block, order, aux, gen,
                    meta_lr):
        if state.batch_stats:
            raise ValueError("the DR lanes cannot carry batch statistics, whose lineage "
                             "chains through the query domains: run the sequential dr_phase")
        device = block["weight"].device
        order, aux = np.asarray(order), np.asarray(aux)
        d, k = aux.shape
        chunk = d if lane_chunk <= 0 else min(int(lane_chunk), d)
        shared_sub = to_sub(shared)
        sub0 = to_sub(state.params)
        seeds = lane_seeds(state.seed, d, device)
        if d % ranks or chunk % ranks:
            raise ValueError(f"{d} lanes in groups of {chunk} do not split over "
                             f"{ranks} data ranks")
        keys = None
        if (chunk < d or ranks > 1) and shuffle:  # the whole dispatch's draws: support j, ...
            shape = (d, block["weight"].shape[-1])
            with trace.span("engine.shuffle"):
                keys = [torch.rand(shape, generator=gen, device=device) for _ in range(2 * k)]

        def run_lanes(lanes: slice, spec_stack):
            """The K support runs of the lanes in ``lanes``; returns their
            lane state and the specific stack with their rows written."""
            order_c, aux_c = order[lanes], aux[lanes]
            with trace.span("engine.lane_state"):
                order_t = torch.as_tensor(order_c, dtype=torch.long, device=device)
                aux_t = torch.as_tensor(aux_c, dtype=torch.long, device=device)
                lane_state = make_lane_state(state, sub0, mask, len(order_c), seeds[lanes])
                spec_lanes = trees.tree_map(lambda m, s: s[order_t] if m else s, mask,
                                            spec_stack)
                query_flats = {c: v[order_t] for c, v in block.items()}  # [C, N_pad]
            for j in range(k):
                with trace.span("engine.merge"):
                    merged = ops.merge_weights(shared_sub, spec_lanes, mask, merged_method)
                    lane_state = lane_state.replace(
                        params=ops.load_masked(lane_state.params, merged, mask))
                with trace.span("engine.shuffle"):
                    support_flats = {c: v[aux_t[:, j]] for c, v in block.items()}
                lane_state, _ = _epoch_on_flat(
                    sub_step, lane_state, support_flats, gen, n_steps, batch,
                    shuffle=shuffle, real_steps=longest(aux_c[:, j]),
                    keys=None if keys is None else keys[2 * j][lanes])
                count_epoch(aux_c[:, j], 0)
                lane_state, _ = _epoch_on_flat(
                    sub_step, lane_state, query_flats, gen, n_steps, batch,
                    cap_steps=domain_regulation_step, shuffle=shuffle,
                    real_steps=longest(order_c),
                    keys=None if keys is None else keys[2 * j + 1][lanes])
                count_epoch(order_c, domain_regulation_step)
                with trace.span("engine.specific_update"):
                    spec_lanes = ops.specific_update(spec_lanes, lane_state.params, merged,
                                                     meta_lr, mask)
            with trace.span("engine.write_back"):
                return lane_state, trees.tree_map(
                    lambda m, st, new: st.index_copy(0, order_t, new) if m else st,
                    mask, spec_stack, spec_lanes)

        mine = []  # the lanes this data rank runs
        for start in range(0, d, chunk):
            lane_state = None  # a group's lane state goes before the next one is made
            per = (min(start + chunk, d) - start) // ranks
            lanes = slice(start + rank * per, start + (rank + 1) * per)
            mine.extend(range(lanes.start, lanes.stop))
            lane_state, specific_stack = run_lanes(lanes, specific_stack)

        def last(x):
            return x[-1] if x.dim() > 0 else x  # placeholders carry no lane axis

        params = trees.tree_map(last, lane_state.params)
        opt_state = type(state.opt_state)(*(x[-1] for x in lane_state.opt_state))
        step = lane_state.step[-1]
        if ranks > 1:
            rows = torch.as_tensor(order[mine], dtype=torch.long, device=device)

            def gathered(m, st):
                if not m:
                    return st
                buf = torch.zeros_like(st)
                buf[rows] = st[rows]
                return all_reduce_sum_(mesh, buf, DATA_AXIS)

            specific_stack = trees.tree_map(gathered, mask, specific_stack)
            src = ranks - 1

            def bcast(x):
                return broadcast(mesh, x, DATA_AXIS, src) if x.dim() > 0 else x

            params = trees.tree_map(bcast, params)
            opt_state = type(opt_state)(*(broadcast(mesh, x, DATA_AXIS, src)
                                          for x in opt_state))
            step = broadcast(mesh, step, DATA_AXIS, src)
        final = state.replace(params=combine(params), opt_state=opt_state, step=step)
        return final, specific_stack

    return dr_parallel


def stack_specific(specific_list: List[Tree], mask: Tree) -> Tree:
    """[per-domain trees] -> one tree with a leading domain axis on masked
    leaves (unmasked leaves take domain 0's tensor itself: never read)."""
    return trees.tree_map(
        lambda m, *leaves: torch.stack(leaves) if m else leaves[0],
        mask, *specific_list)


def unstack_specific(stacked: Tree, mask: Tree, n_domain: int) -> List[Tree]:
    return [trees.tree_map(lambda m, s: s[i] if m else s, mask, stacked)
            for i in range(n_domain)]


def stack_domains_eval(splits: List[DomainSplit], batch_size: int,
                       device) -> Dict[str, torch.Tensor]:
    """Eval block {col: [D, S, B]}: each domain's rows in order, weight-0
    padding (JAX ``stack_domains_eval``, fused.py:245-252)."""
    cols, n_steps = stack_domains_on_device(splits, batch_size, device)
    return {k: v.reshape(v.shape[0], n_steps, batch_size) for k, v in cols.items()}


def make_lane_eval(model, cfg, gather=None):
    """The one lane-batched eval every eval path runs (JAX ``_make_eval_step``
    and its scans, fused.py:254-336).

    Returns eval_lanes(params, block, steps=None, stats=None) -> (losses [L],
    AucState [L, T]). ``params`` ({'model': tree}) holds lane l's weights at
    index l of every leaf with a lane axis; a leaf without one is read by
    every lane (the model's ``apply_lanes`` and ``lane_axes``, for any base
    model). ``stats``, a model's batch statistics, likewise: one tree every
    lane reads (each lane its own batch's domain row) or [L]-stacked; the
    norms run in eval mode.
    ``block`` is {col: [L, S, B]}; ``steps`` lane-steps
    run (all S by default: a lane's trailing all-pad batches change
    nothing). Per lane: the loss is the total loss (data loss — under
    uncertainty weighting bce/var^2 + log(var), var the log_vars entry of the
    lane's batch's domain, from the lane's own log_vars where they carry a
    lane axis — plus the l2 of the lane's embedding tables, the wide term's
    dim-1 tables among them, as ``steps.make_l2_term`` counts them)
    averaged over the batches that hold data, a partial batch by its
    weighted mean; the confusion counts of every
    batch (500 thresholds) are formed from zero and added. Nothing waits for
    the host. ``gather`` is K2's wrapper (on a mesh, ``cfg.lookup``), or its
    plain version to hold the eval through K2 against.
    """
    gather = field_gather(cfg, gather)
    l2_term = make_l2_term(model, cfg)

    def eval_lanes(params, block, steps: Optional[int] = None, stats=None):
        mp = params["model"]
        # [S, L, B]: a lane-step's columns contiguous, as K2 takes its ids
        by_step = {k: v.transpose(0, 1).contiguous() for k, v in block.items()}
        n_steps, lanes = by_step["weight"].shape[:2]
        steps = n_steps if steps is None else min(int(steps), n_steps)
        dev = by_step["weight"].device
        l2 = l2_term(mp, lanes=True)
        log_vars = params["uncertainty"]["log_vars"] if cfg.uncertainty_weight else None
        counts = auc_init(lanes=(lanes,), device=dev)
        loss_sum = torch.zeros((lanes,), dtype=torch.float32, device=dev)
        n = torch.zeros((lanes,), dtype=torch.float32, device=dev)
        with torch.no_grad():
            for s in range(steps):
                b = {k: v[s] for k, v in by_step.items()}
                logits, _ = model_logits(model, mp, b, None, gather, stats)
                data = weighted_bce(logits, b["label"], b["weight"])
                if log_vars is not None:
                    data = uncertainty_loss(data, log_vars, b["domain"])
                loss = data + l2
                with trace.span("eval.auc"):
                    counts = auc_update(counts, b["label"], torch.sigmoid(logits), b["weight"])
                has_data = (torch.sum(b["weight"], dim=-1) > 0.0).to(torch.float32)
                loss_sum = loss_sum + loss * has_data
                n = n + has_data
        return loss_sum / torch.clamp(n, min=1.0), counts

    return eval_lanes


def _split_eval(model, cfg, run, params, block, stats):
    """``run`` (a ``make_lane_eval``) over every domain lane of ``block``; on a
    mesh with a data axis above 1, each data rank runs its block of the
    lanes (``process_local_rows``; a leaf with a lane axis cut to them) and the [L] losses and [L, T] confusion counts are gathered
    over the data group in one exact zero-fill ``all_reduce`` — the counts
    are integers, so the merged AUC equals one device's bit for bit."""
    lookup = cfg.lookup
    if lookup is None or lookup.mesh.data == 1:
        return run(params, block, stats=stats)
    mesh = lookup.mesh
    n = block["weight"].shape[0]
    sl = process_local_rows(n, mesh.data_index, mesh.data)
    dev = block["weight"].device
    counts = auc_init(lanes=(n,), device=dev)
    t = counts.true_positives.shape[-1]
    buf = torch.zeros((n, 1 + 4 * t), dtype=torch.float32, device=dev)
    if sl.stop > sl.start:
        axes = model.lane_axes(params["model"])
        local = dict(params, model=trees.tree_map(
            lambda a, x: x[sl] if a == 0 else x, axes, params["model"]))
        if "uncertainty" in params and params["uncertainty"]["log_vars"].dim() == 3:
            local["uncertainty"] = {"log_vars": params["uncertainty"]["log_vars"][sl]}
        losses, c = run(local, {k: v[sl] for k, v in block.items()}, stats=stats)
        buf[sl] = torch.cat([losses[:, None], *c], dim=1)
    buf = all_reduce_sum_(mesh, buf, DATA_AXIS)
    return buf[:, 0], type(counts)(*torch.split(buf[:, 1:], t, dim=1))


def make_fused_eval(model, cfg):
    """Every domain with one set of weights (JAX ``make_fused_eval``,
    fused.py:339-367): eval_all(params, block [D, S, B], stats=None) -> ([D]
    losses, [D] AUCs), domain d as lane d, every lane reading ``params`` and
    the batch statistics ``stats``."""
    run = make_lane_eval(model, cfg)

    def eval_all(params, block, stats=None):
        losses, counts = _split_eval(model, cfg, run, params, block, stats)
        return losses, auc_result(counts)

    return eval_all


def make_fused_eval_merged(model, cfg, mask, merged_method: str):
    """Every domain with its own merged weights (MAMDR's eval, JAX
    ``make_fused_eval_merged``, fused.py:370-425): eval_all(params, shared,
    specific_stack, block, stats=None) -> ([D] losses, [D] AUCs), where lane d
    reads ``load_masked(params, merge(shared, specific[d]))`` and the batch
    statistics ``stats`` (one tree, each lane its own domain's row). The
    merge is one ``ops.merge_weights`` over the [D]-stacked specific tree,
    as the DR lanes merge."""
    run = make_lane_eval(model, cfg)

    def eval_all(params, shared, specific_stack, block, stats=None):
        merged = ops.merge_weights(shared, specific_stack, mask, merged_method)
        losses, counts = _split_eval(model, cfg, run, ops.load_masked(params, merged, mask),
                                     block, stats)
        return losses, auc_result(counts)

    return eval_all


def make_fused_separate(train_step, model, cfg, n_steps: int, batch: int, combine):
    """Independent per-domain training as lanes (JAX ``make_fused_separate``,
    fused.py:428-483). Returns (epoch_all, eval_all, select_best):

    - epoch_all(states, block [L, N_pad], gen) -> (states, [L] mean
      losses): one shuffled epoch of ``n_steps`` (the longest lane's real
      steps) of every lane through the lane-batched ``train_step``
      (``_epoch_on_flat``); a shorter lane's extra steps are all-pad no-ops;
    - eval_all(params, eval_block [L, S, B], steps=None, stats=None) -> ([L]
      losses, [L] AUCs), lane l with lane l's params (``combine`` maps
      carried params to the full tree, as ``steps.make_subset_train_step``'s
      does) and its batch statistics (the lanes' [L]-stacked ones);
    - select_best(best, current, improved [L] bool) -> best with lane l
      taken from ``current`` where improved[l], for params or batch
      statistics; placeholders of frozen leaves (no lane axis) pass through.
    """
    run = make_lane_eval(model, cfg)

    def epoch_all(states: TrainState, block, gen: torch.Generator):
        return _epoch_on_flat(train_step, states, block, gen, n_steps, batch)

    def eval_all(params, eval_block, steps: Optional[int] = None, stats=None):
        losses, counts = run(combine(params), eval_block, steps, stats)
        return losses, auc_result(counts)

    def select_best(best, current, improved: torch.Tensor):
        def sel(b, c):
            if b.dim() == 0:
                return b
            return torch.where(improved.reshape((-1,) + (1,) * (b.dim() - 1)), c, b)

        return trees.tree_map(sel, best, current)

    return epoch_all, eval_all, select_best
