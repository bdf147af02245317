"""Per-domain separate training and the post-hoc finetune stage, as lanes.

Counterpart of ``mamdr_tpu/strategies/separate.py`` (:26-307: the fused and
bucketed routes and ``_separate_loop``). Reference: BaseModel.separate_train_val_test
(base_model.py:41-109):

  - ``init_params=True`` (the "separate" strategy): every domain starts from
    the trainer's current weights with the trainer's optimizer (Adam);
  - ``init_params=False`` (the finetune stage): domain d starts from
    ``params_fn(d)`` (MAMDR: its merged best weights) with the finetune
    optimizer (plain SGD, lr 1e-3).

Per domain: full epochs with an early stop on its val AUC (patience,
``min_delta``; a domain out of patience is frozen), keeping its best weights,
then its test split with them. Every domain is a lane: one lane-batched
train step (``steps.make_subset_train_step``: kernel K1 over all lanes on
the card for the plain MLP, the autograd lane step through the model's
``apply_lanes`` for any other base model or loss) advances all of them, each with fresh optimizer state, step 0 and
its own dropout stream (``fast_random.lane_seeds``), and one lane eval
scores them. The [D] val AUCs are read once an epoch for the early stop.
Long-tailed data is trained in buckets of similar step counts, so lanes
pad little. A model with batch statistics (STAR) gives every lane the
trainer's current ones, as the JAX package's ``params_fn`` pairs do
(separate.py:143-195); each lane trains its own, and keeps its best
statistics with its best weights.

``separate_fused: false``, and lanes past the memory budget (or a fixed
train order), take the sequential per-domain loop (``_separate_loop``):
domain by domain through ``Trainer.fit_domain`` / ``evaluate_domain``,
starting from the trainer's optimizer state (``init_params``; it is the
fresh one when the separate strategy starts) or from a fresh finetune
optimizer state, with the same early stop. Its ``domain_{d}.npz`` files
hold the domain's whole best tree, frozen tables included, as the JAX
loop's do; the lanes' hold the trainable leaves and a 0-d placeholder at
each frozen table, as the JAX package's fused route's do.
"""

from __future__ import annotations

import os.path as osp
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from mamdr_tpu_torch.ops.fast_random import lane_seeds
from mamdr_tpu_torch.train import fused
from mamdr_tpu_torch.train.state import TrainState
from mamdr_tpu_torch.train.steps import make_subset_train_step
from mamdr_tpu_torch.train.trainer import Trainer
from mamdr_tpu_torch.utils import trace, trees


def separate_train_val_test(trainer: Trainer, init_params: bool = True,
                            params_fn: Optional[Callable[[int], dict]] = None,
                            max_finetune_epochs: Optional[int] = None):
    """Returns (avg_loss, avg_auc, domain_loss, domain_auc) over the test
    splits. ``params_fn(d)`` gives domain d's starting weights (default: the
    trainer's current ones). Every domain runs up to ``max_finetune_epochs``
    epochs (None: ``train.epoch``). The lanes run all domains at once when
    padding them to the longest is cheap (``Trainer.fused_padding_ok``),
    else in buckets of similar step counts; ``separate_fused: false`` or a
    block past the memory budget takes ``_separate_loop``. Each epoch is
    ``_profiled``."""
    t = trainer
    if not t.config.train.separate_fused:
        return _separate_loop(t, init_params, params_fn, max_finetune_epochs)
    if t.fused_padding_ok():
        return _separate_fused(t, init_params, params_fn, max_finetune_epochs)
    if t.fused_padding_ok(ragged=True):
        return _separate_bucketed(t, init_params, params_fn, max_finetune_epochs)
    return _separate_loop(t, init_params, params_fn, max_finetune_epochs)


MAX_BUCKET_RATIO = 2.0  # the JAX package's step_buckets default


def step_buckets(steps: List[int]) -> List[List[int]]:
    """Greedy partition of domain indices by step count: descending sort, a
    new bucket when the bucket's head has more than MAX_BUCKET_RATIO x this
    domain's steps. Bounds a lane's padding by that ratio."""
    order = sorted(range(len(steps)), key=lambda i: -steps[i])
    buckets: List[List[int]] = []
    for i in order:
        if buckets and steps[buckets[-1][0]] <= MAX_BUCKET_RATIO * steps[i]:
            buckets[-1].append(i)
        else:
            buckets.append([i])
    return buckets


def _profiled(trainer: Trainer, init_params: bool, epoch: int, part: str = ""):
    """An epoch of a separate run, ``Trainer.profiled``: the span
    ``trainer.epoch`` and the trace ``[part]epoch_<n>`` when it trains (a
    ``*_separate`` model), ``trainer.finetune`` and
    ``finetune_[part]epoch_<n>`` in the finetune stage; ``part`` names the
    bucket or the domain of a run made of several."""
    if init_params:
        return trainer.profiled(f"{part}epoch_{epoch}", epoch=epoch)
    return trainer.profiled(f"finetune_{part}epoch_{epoch}", "trainer.finetune", epoch)


def _separate_bucketed(trainer: Trainer, init_params: bool, params_fn, max_epochs=None):
    domain_loss: Dict[str, float] = {}
    domain_auc: Dict[str, float] = {}
    for b, bucket in enumerate(step_buckets(trainer.steps_per_domain())):
        _, _, dl, da = _separate_fused(trainer, init_params, params_fn, max_epochs,
                                       domains=bucket, part=f"bucket_{b}_")
        domain_loss.update(dl)
        domain_auc.update(da)
    return trainer.summarize("test", domain_loss, domain_auc)


class Lanes(NamedTuple):
    """One separate / finetune run's lanes: lane l trains domain ``ids[l]``."""
    ids: List[int]
    states: TrainState      # the lanes' start: trainable leaves, batch statistics [L, ...]
    epoch_all: Callable     # (states, block, gen) -> (states, [L] losses)
    eval_all: Callable      # (params, eval block, steps, stats) -> ([L] losses, [L] AUCs)
    select_best: Callable   # (best, current, improved [L]) -> best
    block: Dict[str, torch.Tensor]  # the lanes' train rows {col: [L, N_pad]}
    val_block: Dict[str, torch.Tensor]
    val_steps: int          # the longest lane's real val steps
    test_block: Dict[str, torch.Tensor]
    test_steps: int


def make_lanes(trainer: Trainer, init_params: bool, params_fn=None,
               domains: Optional[List[int]] = None) -> Lanes:
    """Build the lanes of ``domains`` (default: all). Frozen tables are not
    stacked: the carried params hold placeholders there and every lane reads
    the one table (``make_subset_train_step``)."""
    t = trainer
    tc = t.config.train
    tx = t.tx if init_params else t.finetune_tx
    train_step, to_sub, combine = make_subset_train_step(
        t.model, tx, t.step_cfg, t.frozen_mask(), t.state.params)

    ids = list(range(t.dataset.n_domain)) if domains is None else [int(d) for d in domains]
    block, n_steps = t.train_block()
    val_block, test_block = t.eval_block("val"), t.eval_block("test")
    if domains is not None:
        # a bucket: its domains' lanes, cut to its longest step count (real
        # rows sit first in every lane)
        n_steps = max(t.steps_per_domain()[i] for i in ids)
        idx = torch.as_tensor(ids, dtype=torch.long, device=t.device)
        block = {k: v[idx, : n_steps * t.dataset.batch_size] for k, v in block.items()}
        val_block = {k: v[idx] for k, v in val_block.items()}
        test_block = {k: v[idx] for k, v in test_block.items()}
    epoch_all, eval_all, select_best = fused.make_fused_separate(
        train_step, t.model, t.step_cfg, n_steps, t.dataset.batch_size, combine)

    starts = [to_sub(t.state.params if params_fn is None else params_fn(i)) for i in ids]
    params = trees.tree_map(
        lambda *xs: xs[0] if xs[0].dim() == 0 else torch.stack(xs), *starts)
    opt0 = tx.init(starts[0])  # fresh optimizer state, the same for every lane
    n = len(ids)
    states = TrainState(
        params=params,
        opt_state=type(opt0)(*(x.expand(n, *x.shape) for x in opt0)),
        seed=lane_seeds(t.draw_seed(), n, t.device),
        step=torch.zeros((n,), dtype=torch.int32, device=t.device),
        batch_stats=trees.tree_map(lambda x: x.expand(n, *x.shape), t.state.batch_stats),
    )
    longest = lambda mode: max(t.eval_steps_per_domain(mode)[i] for i in ids)  # noqa: E731
    return Lanes(ids, states, epoch_all, eval_all, select_best, block,
                 val_block, longest("val"), test_block, longest("test"))


def _separate_fused(trainer: Trainer, init_params: bool, params_fn, max_epochs=None,
                    domains: Optional[List[int]] = None, part: str = ""):
    t = trainer
    tc = t.config.train
    lanes = make_lanes(t, init_params, params_fn, domains)
    n = len(lanes.ids)
    states = lanes.states
    best, best_stats = states.params, states.batch_stats
    best_auc = np.full(n, -np.inf)
    counter = np.zeros(n, np.int32)
    for epoch in range(max_epochs or tc.epoch):
        with _profiled(t, init_params, epoch, part):
            states, _ = lanes.epoch_all(states, lanes.block, t.gen)
            with trace.span("trainer.validate"):
                _, aucs = lanes.eval_all(states.params, lanes.val_block, lanes.val_steps,
                                         states.batch_stats)
                aucs = trace.to_host(aucs)  # the epoch's one host sync
            # A domain out of patience is frozen (the reference's per-domain
            # Keras EarlyStopping ends its fit, base_model.py:79-82): it keeps
            # training in its lane but can no longer replace its best weights.
            improved = (aucs > best_auc + tc.min_delta) & (counter < tc.patience)
            if improved.any():
                imp = torch.as_tensor(improved, device=t.device)
                best = lanes.select_best(best, states.params, imp)
                best_stats = lanes.select_best(best_stats, states.batch_stats, imp)
        best_auc = np.where(improved, aucs, best_auc)
        counter = np.where(improved, 0, counter + 1)
        if (counter >= tc.patience).all():
            break

    losses, aucs = lanes.eval_all(best, lanes.test_block, lanes.test_steps, best_stats)
    local_loss, local_auc = t.domain_dicts(losses, aucs)
    domain_loss = {str(g): local_loss[str(i)] for i, g in enumerate(lanes.ids)}
    domain_auc = {str(g): local_auc[str(i)] for i, g in enumerate(lanes.ids)}
    if tc.domain_checkpoints:
        # each domain's trainable leaves (frozen tables are placeholders
        # here; they live in model_parameters.npz)
        for i, g in enumerate(lanes.ids):
            t.save_tree(osp.join(t.checkpoint_dir, f"domain_{g}.npz"),
                        trees.tree_map(lambda x: x[i] if x.dim() > 0 else x, best))
    if domains is not None:
        return 0.0, 0.0, domain_loss, domain_auc
    return t.summarize("test", domain_loss, domain_auc)


def _separate_loop(trainer: Trainer, init_params: bool = True, params_fn=None,
                   max_epochs: Optional[int] = None):
    """Every domain on its own, one after another (JAX ``_separate_loop``,
    separate.py:234-307): from ``params_fn(d)`` (default: the trainer's
    params) and the trainer's batch statistics, with the trainer's optimizer
    state and step (``init_params``) or a fresh finetune optimizer state;
    up to ``max_epochs`` (None: ``train.epoch``) epochs of ``fit_domain``,
    each followed by the domain's val AUC; the best weights and statistics
    are those of the last epoch that beat the best by more than
    ``min_delta``, and ``patience`` epochs without one stop the domain; then
    its test split with them. Like the JAX loop it prints the table but logs
    no metrics event."""
    t = trainer
    tc = t.config.train
    domain_loss: Dict[str, float] = {}
    domain_auc: Dict[str, float] = {}
    for idx in range(t.dataset.n_domain):
        params = t.state.params if params_fn is None else params_fn(idx)
        state = t.state.replace(params=params)
        if not init_params:  # a fresh optimizer state a domain (Keras recompile)
            state = state.replace(opt_state=t.finetune_tx.init(params))
        if t.verbose:
            print(f"Train on domain: {idx}")
        best_auc = None
        best_params, best_stats = state.params, state.batch_stats
        counter = 0
        for epoch in range(max_epochs or tc.epoch):
            with _profiled(t, init_params, epoch, f"domain_{idx}_"):
                state, _ = t.fit_domain(state, idx, finetune=not init_params)
                with trace.span("trainer.validate"):
                    _, val_auc = t.evaluate_domain("val", idx, state.params,
                                                   state.batch_stats)
            if best_auc is None or val_auc > best_auc + tc.min_delta:
                best_auc, counter = val_auc, 0
                best_params, best_stats = state.params, state.batch_stats
            else:
                counter += 1
                if counter >= tc.patience:
                    break
        loss, auc = t.evaluate_domain("test", idx, best_params, best_stats)
        domain_loss[str(idx)], domain_auc[str(idx)] = loss, auc
        if tc.domain_checkpoints:  # the whole best tree, frozen tables included
            t.save_tree(osp.join(t.checkpoint_dir, f"domain_{idx}.npz"), best_params)
    avg_loss = sum(domain_loss.values()) / len(domain_loss)
    avg_auc = sum(domain_auc.values()) / len(domain_auc)
    if t.verbose:
        print("Loss: ", domain_loss)
        print("AUC: ")
        for k, v in domain_auc.items():
            print(f"{k}: {v}")
        w = t.weighted_auc("test", domain_auc)
        print(f"Overall test Loss: {avg_loss}, AUC: {avg_auc}, Weighted AUC: {w}")
    return avg_loss, avg_auc, domain_loss, domain_auc
