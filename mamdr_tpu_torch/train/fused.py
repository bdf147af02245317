"""Whole training phases over a device-resident data block.

Counterpart of the DN half of ``mamdr_tpu/train/fused.py``:

  - all domain data lives on the device once, padded to a uniform
    [n_domain, n_steps*batch] block (weight-0 tail rows);
  - epoch shuffling happens on the device: a random-key sort that keeps the
    pad tail last, then ONE gather of all 32-bit columns packed together;
  - the sequential multi-domain pass runs only each domain's ceil(n_d/B)
    real steps (the JAX package's ragged pass, :161-242). A padded step
    would be an all-pad batch, which the train step turns into an exact
    no-op, so skipping it is bit-identical to the padded scan.

The JAX package fuses each phase into one jit dispatch; here a phase is a
Python loop issuing work to one CUDA stream, and nothing in it waits for the
device: shuffle keys come from a generator on the device, per-domain losses
stay on the device, and the caller reads them once at the end.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from mamdr_tpu_torch.data.dataset import DomainSplit
from mamdr_tpu_torch.strategies import ops
from mamdr_tpu_torch.train.state import TrainState


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
                  shuffle: bool = True) -> Dict[str, torch.Tensor]:
    """Shuffled [steps, B] batches from a flat [N_pad] column block, formed
    by ONE gather.

    The shuffle permutes only the real rows and keeps the weight-0 pad tail
    last (stable sort by random key + pad penalty), so the domain trains
    exactly ceil(n_d/B) effective steps. All columns are 32-bit: they are
    packed into one [N_pad, C] int32 array (float columns reinterpreted, a
    bit-exact round trip) and gathered once. Each returned column is
    contiguous, so a step's slice is a contiguous [B] row.
    """
    n_pad = n_steps * batch
    w = flat["weight"]
    if shuffle:
        sort_key = torch.rand(n_pad, generator=gen, device=w.device) + torch.where(
            w > 0.0, 0.0, 2.0)
        perm = torch.argsort(sort_key, stable=True)
    else:
        # equivalence testing: natural order, pad tail last
        perm = torch.arange(n_pad, device=w.device)
    steps = n_steps if cap_steps <= 0 else min(cap_steps, n_steps)
    idx = perm[: steps * batch]
    keys = sorted(flat)
    packed = torch.stack(
        [flat[k] if flat[k].dtype == torch.int32 else flat[k].view(torch.int32)
         for k in keys],
        dim=1,
    )
    rows = packed[idx]  # [steps*B, C]
    out = {}
    for j, k in enumerate(keys):
        col = rows[:, j].contiguous()
        if flat[k].dtype != torch.int32:
            col = col.view(flat[k].dtype)
        out[k] = col.reshape(steps, batch)
    return out


def _sequential_pass(train_step, state: TrainState, block, order: Sequence[int],
                     gen: torch.Generator, steps_of: Sequence[int],
                     n_steps: int, batch: int, shuffle: bool = True):
    """One epoch on each domain in `order`, chained without reset, running
    only each domain's real steps. Returns (state, [D] losses on the device):
    losses[i] is the mean data loss over the real steps of the domain at
    order position i."""
    losses = []
    for dom in order:
        dom = int(dom)
        flat = {k: v[dom] for k, v in block.items()}
        steps = int(steps_of[dom])
        batches = _form_batches(flat, gen, n_steps, batch, cap_steps=steps,
                                shuffle=shuffle)
        loss_sum = torch.zeros((), dtype=torch.float32, device=block["weight"].device)
        for s in range(steps):
            state, loss = train_step(state, {k: v[s] for k, v in batches.items()})
            loss_sum = loss_sum + loss
        losses.append(loss_sum / max(steps, 1))
    return state, torch.stack(losses)


def make_fused_mamdr(train_step, mask, n_steps: int, batch: int,
                     steps_list: Sequence[int], shuffle: bool = True):
    """The MAMDR Domain-Negotiation phase (reference mamdr.py:41-66;
    JAX fused.make_fused_mamdr's dn_phase, :922-927):

        load shared -> sequential pass over `order` -> shared +=
        (θ_end - shared) * meta_lr.

    The DR phase is a later slice. Returns dn_phase(state, shared, block,
    order, gen, meta_lr) -> (state, shared, losses)."""
    steps_of = [int(s) for s in steps_list]

    def dn_phase(state: TrainState, shared, block, order, gen, meta_lr):
        state = state.replace(params=ops.load_masked(state.params, shared, mask))
        state, losses = _sequential_pass(
            train_step, state, block, order, gen, steps_of, n_steps, batch, shuffle)
        shared = ops.reptile_update(shared, state.params, meta_lr, mask)
        return state, shared, losses

    return dn_phase
