"""Flat-vector Adam over the trainable leaves.

Counterpart of ``mamdr_tpu/train/flat_optimizer.py::flat_adam``: every
trainable leaf is ravelled into one vector in JAX leaf order (dict keys
sorted at each level, utils.trees), Adam's elementwise update runs on that
vector, and the step is sliced back into the tree. ``mu`` and ``nu`` are
therefore laid out exactly like the JAX package's and convert 1:1.

Frozen leaves (mask False) take no gradient, get no update (``None``) and
carry no slot state. ``torch.optim.Adam`` is not used: the train step must be
able to discard a whole update, slot counter included, on an all-pad batch
(train/steps.py).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from mamdr_tpu_torch.utils import trees


class FlatAdamState(NamedTuple):
    count: torch.Tensor  # int32 scalar
    mu: torch.Tensor     # [n] flat first moment
    nu: torch.Tensor     # [n] flat second moment


class FlatAdam:
    """Adam over the flattened trainable subset (mask leaves: python bools)."""

    def __init__(self, learning_rate: float, trainable_mask: Any,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.learning_rate = learning_rate
        self.mask = trainable_mask
        self.b1, self.b2, self.eps = b1, b2, eps
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

    def update(self, grads, state: FlatAdamState) -> Tuple[Any, FlatAdamState]:
        """(updates, new_state); updates has grads' structure, None at
        frozen leaves."""
        b1, b2 = self.b1, self.b2
        sel = self._selected(grads)
        g = torch.cat([x.reshape(-1) for x in sel])
        count = state.count + 1
        mu = b1 * state.mu + (1.0 - b1) * g
        nu = b2 * state.nu + (1.0 - b2) * (g * g)
        c = count.to(torch.float32)
        mu_hat = mu / (1.0 - b1 ** c)
        nu_hat = nu / (1.0 - b2 ** c)
        step = -self.learning_rate * mu_hat / (torch.sqrt(nu_hat) + self.eps)

        pieces = iter(torch.split(step, [x.numel() for x in sel]))
        updates = trees.tree_map(
            lambda m, x: next(pieces).reshape(x.shape) if m else None,
            self.mask, grads,
        )
        return updates, FlatAdamState(count=count, mu=mu, nu=nu)


def flat_adam(learning_rate: float, trainable_mask: Any, b1: float = 0.9,
              b2: float = 0.999, eps: float = 1e-8) -> FlatAdam:
    return FlatAdam(learning_rate, trainable_mask, b1, b2, eps)


def apply_updates(params, updates):
    """params + updates leaf by leaf; a None update keeps the leaf itself."""
    return trees.tree_map(lambda p, u: p if u is None else p + u, params, updates)
