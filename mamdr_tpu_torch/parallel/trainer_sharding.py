"""The framework's train step on a (data, table) mesh.

Counterpart of ``mamdr_tpu/parallel/trainer_sharding.py``. The JAX package
jits its one train step with NamedShardings and lets the SPMD partitioner
insert the collectives; here the step is the port's own
(``train/steps.py::make_train_step``) with two mesh pieces:

  - the field gather is the mesh's (``embedding_shard.MeshLookup``);
  - the loss gradient of a one-tower batch is data-parallel
    (``make_data_parallel_loss_grad``): every rank holds the whole batch,
    each data rank computes its rows (K1 for the plain MLP, autograd for
    every other base), the gradients are summed over the data group, and
    the l2 terms go in after that sum. The all-pad gate reads the whole
    batch's weights, so it is the same on every rank.

K1 stays on under the mesh. This departs on purpose from the JAX gate
(``mamdr_tpu/ops/fused_mlp_step.py:231``), which only turns its fused
kernel off because a Pallas kernel cannot take a ``shard_map``-sharded
table: K1 takes the tower input x after the lookup's ``all_reduce``.

``param_sharding_specs`` is the JAX package's rule per leaf name;
``sharded_axes`` is what the port's Trainer really splits: the tables its
lookup shards (``lookup_sharded``: a user or item table of at least
``sharded_lookup_min_rows`` rows) along their rows, and with
``shard_experts`` the MMoE / PLE expert banks the JAX rule splits, along
their leading axis (models/mtl.py runs a rank's experts and sums the
gate-mixed outputs over the table group). A table the JAX rule splits below
``sharded_lookup_min_rows`` is a layout choice there — its lookup is the
plain clamped gather — and is held whole here, with the same numbers.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from mamdr_tpu_torch.models.deepctr import MLP
from mamdr_tpu_torch.models.embeddings import jax_row_sharded, lookup_row_sharded, table_mask
from mamdr_tpu_torch.ops.fast_random import IOTA_MUL, MASK32, fmix32
from mamdr_tpu_torch.parallel.data_feed import data_rows
from mamdr_tpu_torch.parallel.embedding_shard import shard_range
from mamdr_tpu_torch.parallel.mesh import (DATA_AXIS, TABLE_AXIS, Mesh, all_gather_dim0,
                                           all_reduce_sum_)
from mamdr_tpu_torch.utils import trees

ROW, EXPERT = "row", "expert"  # param_sharding_specs' decisions (None: replicated)
_EXPERT = ("expert_kernel", "expert_bias")
_DATA_MIX = 0x27D4EB2F  # decorrelates the data ranks' seeds of a zoo model


def param_sharding_specs(params, mesh: Mesh, shard_experts: bool = False):
    """The JAX rule (trainer_sharding.py:39-62) per leaf: ``ROW`` for a
    table it row-shards (``models/embeddings.jax_row_sharded``) whose rows
    divide the table axis; with ``shard_experts`` ``EXPERT`` for an MMoE /
    PLE expert bank leaf of rank >= 2 whose leading axis divides it; None
    (replicated) otherwise."""
    t = mesh.table

    def spec(name: str, x):
        if jax_row_sharded(name, x) and x.shape[0] % t == 0:
            return ROW
        if (shard_experts and any(k in name for k in _EXPERT) and x.dim() >= 2
                and x.shape[0] % t == 0):
            return EXPERT
        return None

    return trees.named_tree_map(spec, params)


def lookup_sharded(name: str, x: torch.Tensor, mesh: Mesh, min_rows: int) -> bool:
    """Whether the port row-shards the leaf: a table its mesh lookup takes
    (``models/embeddings.lookup_row_sharded``) with at least ``min_rows``
    rows, divisible by the table axis (JAX embedding_lookup.py:45-52)."""
    return (lookup_row_sharded(name) and x.dim() == 2
            and x.shape[0] >= min_rows and x.shape[0] % mesh.table == 0)


def sharded_axes(params, mesh: Mesh, min_rows: int, shard_experts: bool = False):
    """Per leaf of a whole params tree: the axis, counted from the end, that
    the port splits over the table group, or None. -2 for a table the
    lookup shards (``lookup_sharded``: its rows); with ``shard_experts``,
    minus the leaf's rank for an expert-bank leaf the JAX rule splits
    (``param_sharding_specs``' ``EXPERT``: its leading axis). Counted from
    the end, an axis holds for the leaf with or without a leading lane or
    domain axis."""
    specs = param_sharding_specs(params, mesh, shard_experts)

    def axis(name, x, spec):
        if lookup_sharded(name, x, mesh, min_rows):
            return -2
        return -x.dim() if spec == EXPERT else None

    return trees.named_tree_map(axis, params, specs)


def shard_tree(tree, axes, mesh: Mesh):
    """A rank's part of a whole tree: its slice (``shard_range``) of each
    leaf along the axis ``axes`` gives (counted from the end: the rows of
    [n, D] or a stacked [L, n, D], an expert bank's leading axis); other
    leaves, and 0-d placeholders, as they are."""
    def keep(a, x):
        if not a or x.dim() < -a:
            return x
        r = shard_range(mesh, x.shape[a])
        return x.narrow(x.dim() + a, r.start, r.stop - r.start).contiguous()
    return trees.tree_map(keep, axes, tree)


def whole_tree(tree, axes, mesh: Mesh):
    """The inverse of ``shard_tree``: each split leaf's parts gathered over
    the table group, exactly. Every member of the group must call it."""
    def whole(a, x):
        if not a or x.dim() < -a:
            return x
        return all_gather_dim0(mesh, x, TABLE_AXIS, dim=x.dim() + a)
    return trees.tree_map(whole, axes, tree)


def shard_train_state(state, axes, mesh: Mesh, tx):
    """A whole TrainState -> this rank's: its slice of each split leaf
    (``shard_tree``), and flat Adam's slots cut to follow them
    (``shard_flat_slots``)."""
    params = shard_tree(state.params, axes, mesh)
    opt = state.opt_state
    if hasattr(opt, "mu"):
        opt = type(opt)(count=opt.count,
                        mu=shard_flat_slots(opt.mu, state.params, axes, tx, mesh),
                        nu=shard_flat_slots(opt.nu, state.params, axes, tx, mesh))
    return state.replace(params=params, opt_state=opt)


def _map_split_segments(vec: torch.Tensor, params, axes, tx, fn) -> torch.Tensor:
    """A flat Adam slot vector over the trainable leaves of ``params`` with
    each split leaf's segment (shaped [*lead, *leaf.shape]) replaced by
    ``fn(axis, segment)``, in leaf order."""
    out, off, lead = [], 0, vec.shape[:-1]
    for a, sel, x in zip(trees.leaves(axes), tx._trainable, trees.leaves(params)):
        if sel:
            seg = vec[..., off:off + x.numel()]
            off += x.numel()
            out.append((fn(a, seg.reshape(*lead, *x.shape)) if a else seg).reshape(*lead, -1))
    return torch.cat(out, dim=-1) if out else vec


def shard_flat_slots(vec: torch.Tensor, whole_params, axes, tx, mesh: Mesh):
    """A flat Adam slot vector over the whole trainable leaves -> the one
    over this rank's leaves: each split leaf's segment cut to its slice."""
    def cut(a, seg):
        r = shard_range(mesh, seg.shape[a])
        return seg.narrow(seg.dim() + a, r.start, r.stop - r.start)
    return _map_split_segments(vec, whole_params, axes, tx, cut)


def whole_flat_slots(vec: torch.Tensor, params, axes, tx, mesh: Mesh) -> torch.Tensor:
    """The inverse of ``shard_flat_slots``: a flat Adam slot vector over this
    rank's leaves of ``params`` -> the one over the whole leaves, in the
    whole tree's flat order, each split leaf's segment gathered over the
    table group (exactly). Every member of the group must call it."""
    return _map_split_segments(vec, params, axes, tx, lambda a, seg: all_gather_dim0(
        mesh, seg.contiguous(), TABLE_AXIS, dim=seg.dim() + a))


def whole_train_state(state, axes, mesh: Mesh, tx):
    """The inverse of ``shard_train_state``: this rank's TrainState -> the
    whole one (``whole_tree`` of the params, ``whole_flat_slots`` of flat
    Adam's slots). Every member of the table group must call it."""
    opt = state.opt_state
    if hasattr(opt, "mu"):
        opt = type(opt)(count=opt.count,
                        mu=whole_flat_slots(opt.mu, state.params, axes, tx, mesh),
                        nu=whole_flat_slots(opt.nu, state.params, axes, tx, mesh))
    return state.replace(params=whole_tree(state.params, axes, mesh), opt_state=opt)


def row_offset_seeds(seeds: torch.Tensor, first_row: int, widths) -> torch.Tensor:
    """Dropout seeds for rows starting at global row ``first_row``: the hash
    takes (idx * 2654435761 + seed) mod 2**32 over a layer's flat row-major
    index (ops/fast_random.py), so a row offset o is the seed plus o *
    width * 2654435761. Layer i of width ``widths[i]``; the masks of rows
    [o, o + b) then equal those rows of one device's [B, width] mask."""
    shift = torch.tensor([(first_row * int(w) * IOTA_MUL) & MASK32 for w in widths],
                         dtype=torch.int64, device=seeds.device)
    return (seeds + shift) & MASK32


def make_data_parallel_loss_grad(base: Callable, model, cfg, mesh: Optional[Mesh] = None):
    """The one-tower loss gradient over the data group. ``base``: the
    model's loss gradient with the mesh lookup and NO l2 term; ``cfg``: the
    step's (its l2 is added here, after the sum).

    f(params, batch, seeds, train=True, stats=None) takes the WHOLE batch
    ([B] columns, B divisible by the data axis, else ``ValueError``) and
    returns what ``base`` returns for the whole batch: each data rank runs
    ``base`` on its rows (``data_rows``), whose loss is normalised by its own
    weights, so its loss and gradients are rescaled by max(W_r, 1) /
    max(W, 1) to the global mean's (W the whole batch's weight sum, W_r its
    rows'); the rescaled gradients and loss are summed over the data group
    in ONE ``all_reduce`` of one flat buffer; then each embedding table's l2
    gradient 2 * l2 * table is added (a shard's own rows). Dropout: the
    plain MLP's per-layer seeds are shifted by the rank's first row
    (``row_offset_seeds``), so the masks equal one device's; a zoo model's
    are mixed with the data index (independent masks, not one device's).
    A model with batch statistics is refused on a data axis above 1 (its
    norms would see one rank's rows), and so is the uncertainty-weighted
    loss (its log-variance term does not scale with the rows' weights)."""
    mesh = mesh or cfg.lookup.mesh
    l2 = float(cfg.l2_emb)
    tables = table_mask(model.param_tree())
    widths = [int(h) for h in model.hidden_dim] if isinstance(model, MLP) else None
    if model.has_batch_stats and mesh.data > 1:
        raise ValueError("a model with batch statistics cannot be data-parallel: its norms "
                         "would see one rank's rows (use a data axis of 1)")
    if cfg.uncertainty_weight and mesh.data > 1:
        raise ValueError("the uncertainty-weighted loss cannot be data-parallel: its "
                         "log-variance term does not split by rows (use a data axis of 1)")

    def loss_grad(params, batch, seeds, train: bool = True, **kw):
        rows = data_rows(mesh, batch["uid"].shape[0])
        local = {k: v[rows] for k, v in batch.items()}
        if train and rows.start and seeds is not None:
            seeds = (row_offset_seeds(seeds, rows.start, widths) if widths is not None
                     else fmix32((seeds + mesh.data_index * _DATA_MIX) & MASK32))
        out = base(params, local, seeds, train, **kw)
        data_loss, grads = out[0], out[1]
        w_all = torch.clamp(torch.sum(batch["weight"]), min=1.0)
        scale = torch.clamp(torch.sum(local["weight"]), min=1.0) / w_all
        live = [g for g in trees.leaves(grads) if g is not None]
        flat = torch.cat([(g * scale).reshape(-1) for g in live]
                         + [(data_loss * scale).reshape(1)])
        flat = all_reduce_sum_(mesh, flat, DATA_AXIS)
        pieces = iter(torch.split(flat[:-1], [g.numel() for g in live]))
        grads = trees.tree_map(lambda g: None if g is None else next(pieces).view(g.shape),
                               grads)
        if l2:  # each table's l2 gradient, after the sum
            grads["model"] = trees.tree_map(
                lambda g, t, p: g + 2.0 * l2 * p if t and g is not None else g,
                grads["model"], tables, params["model"])
        return (flat[-1].reshape(data_loss.shape), grads, *out[2:])

    return loss_grad


def make_sharded_full_step(trainer):
    """(step, state) of a Trainer built on a mesh: the trainer's own train
    step (``Trainer.train_step_fn``: the mesh lookup, data-parallel rows)
    and its state, whose row-sharded tables and Adam slots are already this
    rank's (JAX ``make_sharded_full_step``, trainer_sharding.py:83-102). The
    caller feeds whole batches (``make_sharded_batch``)."""
    if trainer.mesh is None:
        raise ValueError("the trainer was built without a mesh")
    return trainer.train_step_fn(), trainer.state


def make_sharded_batch(mesh: Mesh, n_uid: int, n_pid: int, n_domain: int, batch: int,
                       domain_id: int = 0) -> Dict[str, torch.Tensor]:
    """A whole batch of random rows from ``default_rng(0)`` on the rank's
    device, as the JAX ``make_sharded_batch`` draws it (the same values on
    every rank)."""
    rng = np.random.default_rng(0)
    cols = {
        "uid": rng.integers(0, n_uid, batch).astype(np.int32),
        "pid": rng.integers(0, n_pid, batch).astype(np.int32),
        "domain": np.full(batch, domain_id, np.int32),
        "label": rng.integers(0, 2, batch).astype(np.float32),
        "weight": np.ones(batch, np.float32),
    }
    return {k: torch.from_numpy(v).to(mesh.device) for k, v in cols.items()}
