"""The train step shared by every execution path, and its loss and optimizer.

Counterpart of ``mamdr_tpu/train/steps.py`` for the MLP tower:

  - binary cross-entropy on logits, masked weighted mean
    sum(w*bce)/max(sum(w), 1) (Keras weighted loss with 0/1 weights);
  - l2 1e-5 on the embedding tables, frozen tables contributing a constant;
  - one train step = fused tower gradient (ops/fused_mlp_step.py), the
    optimizer (flat Adam, or masked SGD in the finetune stage), and the
    all-pad gate: a batch whose weights sum to 0 leaves
    params, optimizer slots and ``step`` exactly as they were
    (steps.py:148-165). The gate is a ``torch.where`` on the device, so a
    step never waits for the host;
  - the subset lane step (``make_subset_train_step``, steps.py:171-236): the
    very same step function over lane-stacked state that carries only
    trainable leaves, with the gate taken per lane.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from mamdr_tpu_torch.ops.fast_random import step_seeds
from mamdr_tpu_torch.ops.fused_mlp_step import make_fast_loss_grad
from mamdr_tpu_torch.train.flat_optimizer import apply_updates, flat_adam, masked_sgd
from mamdr_tpu_torch.train.state import TrainState
from mamdr_tpu_torch.utils import trees


class StepConfig(NamedTuple):
    l2_emb: float = 1e-5
    emb_trainable: bool = True


def weighted_bce(logits, labels, weights):
    """sum(w * bce) / max(sum(w), 1) over the last axis —
    optax.sigmoid_binary_cross_entropy math; [B] gives [], [L, B] gives [L]."""
    bce = (
        torch.clamp(logits, min=0.0)
        - logits * labels
        + torch.log1p(torch.exp(-torch.abs(logits)))
    )
    denom = torch.clamp(torch.sum(weights, dim=-1), min=1.0)
    return torch.sum(bce * weights, dim=-1) / denom


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
    """loss_fn(params, batch, seeds=None, probs=False) -> (loss, data_loss),
    or (loss, data_loss, probabilities) when ``probs``: the model's forward
    pass (dropout iff seeds are given) and the loss on it."""

    def loss_fn(params, batch, seeds=None, probs: bool = False):
        logits = model.apply(params["model"], batch["uid"], batch["pid"],
                             batch["domain"], seeds)
        data_loss = weighted_bce(logits, batch["label"], batch["weight"])
        loss = data_loss + _l2_term(params["model"], cfg.l2_emb, cfg.emb_trainable)
        if probs:
            return loss, data_loss, torch.sigmoid(logits)
        return loss, data_loss

    return loss_fn


def make_train_step(model, tx, cfg: StepConfig, loss_grad: Optional[Callable] = None,
                    combine: Optional[Callable] = None):
    """(state, batch) -> (state, data_loss), for one tower (batch columns
    [B], ``step`` []) or for L lanes at once (every carried leaf [L, ...],
    batch columns [L, B], ``step`` and ``seed`` [L]): seeds, loss and
    gradient, the optimizer and the gate all broadcast over the lane axis,
    and the gate is taken per lane; the optimizer state keeps its own type
    (flat Adam's slots, or SGD's empty state). ``loss_grad`` defaults to the fused kernel
    path (make_fast_loss_grad); ``combine`` maps the carried params to the
    tree the loss reads (make_subset_train_step)."""
    if loss_grad is None:
        loss_grad = make_fast_loss_grad(model, cfg)
    n_layers = len(model.hidden_dim)

    def train_step(state: TrainState, batch):
        seeds = step_seeds(state.seed, state.step, n_layers)
        params = state.params if combine is None else combine(state.params)
        data_loss, grads = loss_grad(params, batch, seeds, train=True)
        updates, new_opt = tx.update(grads, state.opt_state)
        new_params = apply_updates(state.params, updates)
        has_data = torch.sum(batch["weight"], dim=-1) > 0.0  # [] or [L]

        def keep(new, old):
            if new is old:  # frozen leaves and their placeholders
                return old
            gate = has_data[(...,) + (None,) * (new.dim() - has_data.dim())]
            return torch.where(gate, new, old)

        new_state = state.replace(
            params=trees.tree_map(keep, new_params, state.params),
            opt_state=type(state.opt_state)(
                *(keep(n, o) for n, o in zip(new_opt, state.opt_state))),
            step=state.step + has_data.to(state.step.dtype),
        )
        return new_state, data_loss

    return train_step


def make_subset_train_step(model, tx, cfg: StepConfig, frozen_mask, frozen_full,
                           loss_grad: Optional[Callable] = None):
    """Train step over L lanes whose carried params hold only the TRAINABLE
    subset. Returns (train_step, to_sub, combine).

    The carried state is lane-stacked: every trainable leaf [L, ...],
    optimizer slots [L, n], ``step`` [L], ``seed`` [L]; batch columns [L, B].
    Frozen leaves (``frozen_mask`` True: the pretrained user/item tables
    when emb_trainable is false) are captured once from ``frozen_full`` and
    shared by every lane: ``to_sub(full)`` puts a scalar placeholder in
    their place, ``combine(sub)`` restores the one shared tensor, so L lanes
    never hold L copies of a table. ``train_step`` is make_train_step's step
    reading ``combine(params)``: one call advances all lanes through the
    lane-batched kernel K1, and a lane whose batch weights sum to 0 keeps
    its params, slots and step exactly while the others move, with no host
    sync.
    """

    def to_sub(full):
        return trees.tree_map(lambda f, x: x.new_zeros(()) if f else x, frozen_mask, full)

    def combine(sub):
        return trees.tree_map(lambda f, fr, x: fr if f else x,
                              frozen_mask, frozen_full, sub)

    return make_train_step(model, tx, cfg, loss_grad, combine), to_sub, combine


def make_optimizer(name: str, learning_rate: float, params,
                   emb_trainable: bool = True, flat: bool = True):
    """Inner optimizer: flat Adam (TF1 AdamOptimizer defaults: b1=.9 b2=.999
    eps=1e-8) or plain SGD (the finetune stage's).

    When ``emb_trainable`` is false the user/item tables are frozen: no
    gradient, no update, no slots. Adam is ported in its flat form only,
    which the JAX package holds bit-exact to optax.adam.
    """
    if name not in ("adam", "sgd"):
        raise ValueError(f"unknown optimizer {name!r}")
    if name == "adam" and not flat:
        raise NotImplementedError(
            "optimizer 'adam' with flat=False is not ported; flat Adam is the same function")

    def trainable(name_: str, x) -> bool:
        return emb_trainable or not ("user_emb" in name_ or "item_emb" in name_)

    mask = trees.named_tree_map(trainable, params)
    return flat_adam(learning_rate, mask) if name == "adam" else masked_sgd(learning_rate, mask)
