"""The train step shared by every execution path, and its loss and optimizer.

Counterpart of ``mamdr_tpu/train/steps.py`` for the MLP tower:

  - binary cross-entropy on logits, masked weighted mean
    sum(w*bce)/max(sum(w), 1) (Keras weighted loss with 0/1 weights);
  - l2 1e-5 on the embedding tables, frozen tables contributing a constant;
  - one train step = fused tower gradient (ops/fused_mlp_step.py), flat
    Adam, and the all-pad gate: a batch whose weights sum to 0 leaves
    params, optimizer slots and ``step`` exactly as they were
    (steps.py:148-165). The gate is a ``torch.where`` on the device, so a
    step never waits for the host.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from mamdr_tpu_torch.ops.fast_random import step_seeds
from mamdr_tpu_torch.ops.fused_mlp_step import make_fast_loss_grad
from mamdr_tpu_torch.train.flat_optimizer import FlatAdamState, apply_updates, flat_adam
from mamdr_tpu_torch.train.state import TrainState
from mamdr_tpu_torch.utils import trees


class StepConfig(NamedTuple):
    l2_emb: float = 1e-5
    emb_trainable: bool = True


def weighted_bce(logits, labels, weights):
    """sum(w * bce) / max(sum(w), 1) — optax.sigmoid_binary_cross_entropy math."""
    bce = (
        torch.clamp(logits, min=0.0)
        - logits * labels
        + torch.log1p(torch.exp(-torch.abs(logits)))
    )
    denom = torch.clamp(torch.sum(weights), min=1.0)
    return torch.sum(bce * weights) / denom


def _l2_term(model_params, l2_emb: float, emb_trainable: bool):
    """l2 * sum(table^2) over embedding-table params ('emb' in path); frozen
    tables are detached (their term is a constant)."""
    if l2_emb <= 0.0:
        return 0.0
    total = 0.0
    for name, x in trees.leaves_with_names(model_params):
        if "emb" not in name:
            continue
        t = torch.sum(torch.square(x))
        if not emb_trainable and ("user_emb" in name or "item_emb" in name):
            t = t.detach()
        total = total + t
    return l2_emb * total


def make_loss_fn(model, cfg: StepConfig):
    """loss_fn(params, batch, seeds=None) -> (loss, data_loss): the model's
    forward pass (dropout iff seeds are given) and the loss on it."""

    def loss_fn(params, batch, seeds=None):
        logits = model.apply(params["model"], batch["uid"], batch["pid"],
                             batch["domain"], seeds)
        data_loss = weighted_bce(logits, batch["label"], batch["weight"])
        loss = data_loss + _l2_term(params["model"], cfg.l2_emb, cfg.emb_trainable)
        return loss, data_loss

    return loss_fn


def make_train_step(model, tx, cfg: StepConfig, loss_grad: Optional[Callable] = None):
    """(state, batch) -> (state, data_loss). ``loss_grad`` defaults to the
    fused kernel path (make_fast_loss_grad)."""
    if loss_grad is None:
        loss_grad = make_fast_loss_grad(model, cfg)
    n_layers = len(model.hidden_dim)

    def train_step(state: TrainState, batch):
        seeds = step_seeds(state.seed, state.step, n_layers)
        data_loss, grads = loss_grad(state.params, batch, seeds, train=True)
        updates, new_opt = tx.update(grads, state.opt_state)
        new_params = apply_updates(state.params, updates)
        has_data = torch.sum(batch["weight"]) > 0.0

        def keep(new, old):
            return old if new is old else torch.where(has_data, new, old)

        new_state = state.replace(
            params=trees.tree_map(keep, new_params, state.params),
            opt_state=FlatAdamState(*(keep(n, o) for n, o in zip(new_opt, state.opt_state))),
            step=state.step + has_data.to(state.step.dtype),
        )
        return new_state, data_loss

    return train_step


def make_optimizer(name: str, learning_rate: float, params,
                   emb_trainable: bool = True, flat: bool = True):
    """Inner optimizer (TF1 AdamOptimizer defaults: b1=.9 b2=.999 eps=1e-8).

    When ``emb_trainable`` is false the user/item tables are frozen: no
    gradient, no update, no slots. Only flat Adam is ported so far.
    """
    if name != "adam" or not flat:
        raise NotImplementedError(
            f"optimizer {name!r} (flat={flat}) is not ported yet; use flat adam"
        )

    def trainable(name_: str, x) -> bool:
        return emb_trainable or not ("user_emb" in name_ or "item_emb" in name_)

    return flat_adam(learning_rate, trees.named_tree_map(trainable, params))
