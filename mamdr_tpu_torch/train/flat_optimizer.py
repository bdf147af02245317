"""Flat-vector Adam over the trainable leaves, and masked SGD.

Counterpart of ``mamdr_tpu/train/flat_optimizer.py::flat_adam``: every
trainable leaf is ravelled into one vector in JAX leaf order (dict keys
sorted at each level, utils.trees), Adam's elementwise update runs on that
vector, and the step is sliced back into the tree. ``mu`` and ``nu`` are
therefore laid out exactly like the JAX package's and convert 1:1.

The update is elementwise, so the same code serves a lane-stacked state
(the DR phase's query-domain lanes): ``mu`` and ``nu`` [L, n], ``count``
[L], every gradient leaf with a leading L — lane l's slots then hold exactly
what a single-lane optimizer fed lane l's gradients would.

Frozen leaves (mask False) take no gradient, get no update (``None``) and
carry no slot state. ``torch.optim.Adam`` is not used: the train step must be
able to discard a whole update, slot counter included, on an all-pad batch
(train/steps.py). ``step``, every caller's one entry (train steps, meta
steps, the sharded trainer), is the update, its apply and that gate, which
on the card are one launch of kernel K4 (``ops/fused_adam_update.py``) over
the trainable leaves and the slots as they are laid out here.

``train.flat_optimizer: false`` (the JAX package's
``make_optimizer(flat=False)``, train/steps.py:369-389: ``optax.adam``, or
with frozen tables ``optax.chain(masked(set_to_zero), masked(adam))``) runs
this same Adam, which gives optax.adam's numbers (the JAX package holds its
flat form to optax.adam at rtol 1e-6, tests/test_strategy_ops.py); what
differs is only how a resume snapshot lays out the state. ``optax_path``
says where the optax state keeps Adam's (count, mu, nu) — ``("0",)`` for
``optax.adam``, ``("1", "inner_state", "0")`` inside the masked chain —
and ``to_optax`` / ``from_optax`` convert between the flat slots and that
layout's per-leaf trees (trainable leaves only, as the masked chain holds no
slot at a frozen leaf).

``MaskedSgd`` is the finetune stage's optimizer (optax.sgd under the JAX
package's frozen-table mask): updates ``-lr * g`` on trainable leaves, none
at frozen ones, and no state. It serves a lane-stacked state unchanged.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from mamdr_tpu_torch.ops.fused_adam_update import adam_moments, fused_adam_update, gated
from mamdr_tpu_torch.utils import trace, trees


class FlatAdamState(NamedTuple):
    count: torch.Tensor  # int32 scalar, or [L] over lanes
    mu: torch.Tensor     # [n] flat first moment, or [L, n]
    nu: torch.Tensor     # [n] flat second moment, or [L, n]


class FlatAdam:
    """Adam over the flattened trainable subset (mask leaves: python bools).
    ``optax_path``: None, or where the JAX package's per-leaf optax state
    keeps Adam's slots (a resume snapshot's layout, ``to_optax``)."""

    def __init__(self, learning_rate: float, trainable_mask: Any,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 optax_path: Optional[Tuple[str, ...]] = None):
        self.learning_rate = learning_rate
        self.mask = trainable_mask
        self.b1, self.b2, self.eps = b1, b2, eps
        self.optax_path = optax_path
        self._trainable = trees.leaves(trainable_mask)

    def _selected(self, tree):
        return [x for m, x in zip(self._trainable, trees.leaves(tree)) if m]

    def init(self, params) -> FlatAdamState:
        sel = self._selected(params)
        n = sum(x.numel() for x in sel)
        device = sel[0].device if sel else None
        return FlatAdamState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            mu=torch.zeros((n,), dtype=torch.float32, device=device),
            nu=torch.zeros((n,), dtype=torch.float32, device=device),
        )

    def _corrections(self, count: torch.Tensor, lead) -> Tuple[torch.Tensor, torch.Tensor]:
        """Adam's bias corrections ``1 - b1**count`` and ``1 - b2**count`` in
        float32, shaped [*lead, 1]."""
        c = count.to(torch.float32).reshape(*lead, 1)
        return 1.0 - self.b1 ** c, 1.0 - self.b2 ** c

    def update(self, grads, state: FlatAdamState) -> Tuple[Any, FlatAdamState]:
        """(updates, new_state); updates has grads' structure, None at
        frozen leaves. Leading lane axes of the state are those of every
        gradient leaf."""
        with trace.span("step.adam"):
            sel = self._selected(grads)
            lead = state.mu.shape[:-1]  # () or (L,)
            g = torch.cat([x.reshape(*lead, -1) for x in sel], dim=-1)
            count = state.count + 1
            bc1, bc2 = self._corrections(count, lead)
            step, mu, nu = adam_moments(g, state.mu, state.nu, bc1, bc2, self.learning_rate,
                                        self.b1, self.b2, self.eps)
            pieces = iter(torch.split(step, [x[(0,) * len(lead)].numel() for x in sel],
                                      dim=-1))
            updates = trees.tree_map(
                lambda m, x: next(pieces).reshape(x.shape) if m else None,
                self.mask, grads,
            )
            return updates, FlatAdamState(count=count, mu=mu, nu=nu)

    def step(self, params, grads, state: FlatAdamState,
             has_data: torch.Tensor) -> Tuple[Any, FlatAdamState]:
        """The train step's optimizer: (params', state') — ``update``, its
        updates applied and the all-pad gate in one call. ``has_data`` (bool,
        [] or one a lane) keeps a lane's params and slots, count included,
        exactly as they were where its batch holds no data.

        On the card the trainable leaves and the slots take one launch of
        kernel K4 (``ops/fused_adam_update.py``: fresh buffers, nothing
        written in place) in the span ``step.adam``; ``step.apply`` puts the
        new leaves in the tree and ``step.gate`` gates the count. On the CPU
        it is ``update`` and ``apply_gated``, each in its span, which K4
        equals bit for bit (the CPU route goes through ``update``, where the
        benchmark's CPU tests plant their faults)."""
        sel_p, sel_g = self._selected(params), self._selected(grads)
        if all(t.device.type == "cpu" for t in (state.mu, state.nu, *sel_p, *sel_g)):
            return apply_gated(params, *self.update(grads, state), state, has_data)
        with trace.span("step.adam"):
            count = state.count + 1
            bc1, bc2 = self._corrections(count, state.mu.shape[:-1])
            # an autograd gradient may come strided (a parameter read through a
            # transpose); K4 reads gradients contiguous
            outs, mu, nu = fused_adam_update(sel_p, [g.contiguous() for g in sel_g], state.mu,
                                             state.nu, bc1, bc2, has_data, self.learning_rate,
                                             self.b1, self.b2, self.eps)
        with trace.span("step.apply"):
            new_leaves = iter(outs)
            new_params = trees.tree_map(lambda m, p: next(new_leaves) if m else p,
                                        self.mask, params)
        with trace.span("step.gate"):
            count = torch.where(has_data, count, state.count)
        return new_params, FlatAdamState(count=count, mu=mu, nu=nu)

    def to_optax(self, state: FlatAdamState, params) -> Dict[str, Any]:
        """One tower's state in the per-leaf optax layout: ``{"count", "mu",
        "nu"}`` (mu / nu trees of the trainable leaves, shaped as in
        ``params``) nested under ``optax_path``."""
        shapes = [(n, x.shape) for (n, x), m in zip(trees.leaves_with_names(params),
                                                     self._trainable) if m]

        def tree(v):
            pieces = torch.split(v, [s.numel() for _, s in shapes])
            return trees.unflatten({n: p.reshape(s) for (n, s), p in zip(shapes, pieces)})

        out: Dict[str, Any] = {"count": state.count, "mu": tree(state.mu), "nu": tree(state.nu)}
        for part in reversed(self.optax_path):
            out = {part: out}
        return out

    def from_optax(self, tree: Dict[str, Any]) -> FlatAdamState:
        """``to_optax``'s inverse: the slots' leaves joined in leaf order."""
        tree = trees.at(tree, self.optax_path)
        return FlatAdamState(
            count=tree["count"],
            mu=torch.cat([x.reshape(-1) for x in trees.leaves(tree["mu"])]),
            nu=torch.cat([x.reshape(-1) for x in trees.leaves(tree["nu"])]))


class SgdState(NamedTuple):
    """SGD carries no state (an empty tuple, lane-stacked or not)."""


class MaskedSgd:
    """Plain SGD on the leaves the mask marks (python bools)."""

    def __init__(self, learning_rate: float, trainable_mask: Any):
        self.learning_rate = learning_rate
        self.mask = trainable_mask

    def init(self, params) -> SgdState:
        return SgdState()

    def update(self, grads, state: SgdState) -> Tuple[Any, SgdState]:
        """(updates, state): ``-lr * g`` per trainable leaf, None at frozen
        ones (p + (-lr * g) is p - lr * g bit for bit)."""
        lr = self.learning_rate
        with trace.span("step.sgd"):
            return trees.tree_map(lambda m, g: -lr * g if m else None, self.mask, grads), state

    def step(self, params, grads, state: SgdState,
             has_data: torch.Tensor) -> Tuple[Any, SgdState]:
        """The train step's optimizer: ``update`` and ``apply_gated``."""
        return apply_gated(params, *self.update(grads, state), state, has_data)


@functools.lru_cache(maxsize=None)
def true_on(device: torch.device) -> torch.Tensor:
    """``step``'s has_data for a step that always holds data: a 0-d True made
    on ``device`` once, by ``torch.ones`` (no copy of a host bool)."""
    return torch.ones((), dtype=torch.bool, device=device)


def apply_updates(params, updates):
    """params + updates leaf by leaf; a None update keeps the leaf itself."""
    return trees.tree_map(lambda p, u: p if u is None else p + u, params, updates)


def apply_gated(params, updates, new_state, state, has_data: torch.Tensor):
    """(params', state'): ``apply_updates`` (span ``step.apply``), then the
    all-pad gate (span ``step.gate``): every updated leaf and every field of
    the optimizer state keeps its old value in the lanes whose ``has_data``
    is false."""
    with trace.span("step.apply"):
        new_params = apply_updates(params, updates)
    with trace.span("step.gate"):
        return (trees.tree_map(lambda n, o: o if n is o else gated(has_data, n, o),
                               new_params, params),
                type(state)(*(gated(has_data, n, o) for n, o in zip(new_state, state))))
