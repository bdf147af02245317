"""Parameter trees between the two frameworks, keyed by the flax names.

The port's parameter trees are nested dicts with the flax paths
(``model/dnn/Dense_0/Dense_0/kernel``) and the flax layouts (kernels
``[in, out]``, biases ``[out]``, MTL kernels ``[T, in, out]`` /
``[T, t, in, out]``, CCPM's conv kernels HWIO ``[W, 1, in, out]``), so
conversion is a leaf-wise copy with no renaming or transposing, for every
base model (the uncertainty-weighted model's ``uncertainty/log_vars``
included). STAR's batch statistics, flax's ``batch_stats`` collection, keep
their paths too (``partitioned_norm/{moving_mean,moving_var}``,
``bn/{mean,var}``; ``batch_stats_from_jax``). Inputs are nested dicts of numpy arrays (e.g.
``jax.device_get`` of a flax tree); this module imports no JAX.
"""

from __future__ import annotations

from typing import Any, List

import numpy as np
import torch

from mamdr_tpu_torch.train.flat_optimizer import FlatAdam, FlatAdamState
from mamdr_tpu_torch.utils import trees


def params_from_jax(tree_of_numpy: Any) -> Any:
    """Nested dict of arrays -> nested dict of CPU tensors (copies, same dtypes)."""
    return trees.tree_map(lambda x: torch.tensor(np.asarray(x)), tree_of_numpy)


def batch_stats_from_jax(tree_of_numpy: Any, device="cpu") -> Any:
    """A flax ``batch_stats`` collection (nested numpy, ``{}`` for a model
    without a norm) -> the port's ``TrainState.batch_stats``: the same paths,
    float32 tensors on `device`."""
    return trees.tree_map(
        lambda x: torch.tensor(np.asarray(x), dtype=torch.float32, device=device),
        dict(tree_of_numpy))


def params_to_numpy(port_params: Any) -> Any:
    """Nested dict of tensors -> nested dict of numpy arrays (host copies)."""
    return trees.tree_map(lambda t: t.detach().cpu().numpy(), port_params)


def spec_stack_from_jax(stack_of_numpy: Any, mask: Any, shared: Any) -> Any:
    """The JAX package's [D]-stacked specific tree (fused.stack_specific, as
    numpy) -> the port's: masked leaves become tensors on `shared`'s device;
    unmasked leaves, which are never read, alias `shared`'s tensors as the
    port's own stack does (no second copy of a frozen table)."""
    return trees.tree_map(
        lambda m, x, s: torch.tensor(np.asarray(x), device=s.device) if m else s,
        mask, stack_of_numpy, shared)


def specific_from_jax(specific_of_numpy: List[Any], mask: Any, shared: Any) -> List[Any]:
    """A JAX MAMDR strategy's per-domain specific trees (``specific`` or
    ``best_specific``, as numpy) -> the port's list: masked leaves become
    tensors on `shared`'s device, unmasked leaves alias `shared`'s, as the
    port's strategy keeps them."""
    return [spec_stack_from_jax(tree, mask, shared) for tree in specific_of_numpy]


def flat_adam_state_from_jax(count, mu, nu, device="cpu") -> FlatAdamState:
    """The JAX package's flat Adam slots (numpy) -> the port's. Both ravel
    the trainable leaves in the same order, so the vectors carry over 1:1."""
    return FlatAdamState(
        count=torch.tensor(np.asarray(count), dtype=torch.int32, device=device),
        mu=torch.tensor(np.asarray(mu), dtype=torch.float32, device=device),
        nu=torch.tensor(np.asarray(nu), dtype=torch.float32, device=device),
    )


def adam_state_from_jax(opt_state, emb_trainable: bool = True, device="cpu") -> FlatAdamState:
    """The JAX package's per-leaf Adam state (``make_optimizer(flat=False)``,
    as numpy: ``optax.adam``'s ``(ScaleByAdamState(count, mu, nu),
    EmptyState())``, or with frozen tables the chain ``(MaskedState(...),
    MaskedState(inner_state=(ScaleByAdamState, EmptyState())))`` whose mu /
    nu hold ``MaskedNode`` at frozen leaves) -> the port's flat Adam slots:
    the trainable leaves of mu and nu ravelled in leaf order."""
    adam_state = opt_state[0] if emb_trainable else opt_state[1].inner_state[0]

    def flat(tree):  # optax's MaskedNode (no shape) marks a frozen leaf
        return np.concatenate([np.asarray(x, np.float32).reshape(-1)
                               for x in trees.leaves(tree) if hasattr(x, "shape")])

    return flat_adam_state_from_jax(adam_state.count, flat(adam_state.mu),
                                    flat(adam_state.nu), device)


def meta_adam_state_from_jax(count, mu_tree, nu_tree, mask, device="cpu") -> FlatAdamState:
    """The JAX package's meta-optimizer state (``optax.adam``'s count and its
    mu / nu trees, as numpy, under ``optax.chain(masked(set_to_zero), adam)``)
    -> the port's flat Adam over the meta mask: the masked leaves of mu and
    nu ravelled in leaf order (the JAX package's other leaves hold zeros and
    never move; the port carries no slot for them)."""
    def flat(tree):
        sel = [np.asarray(x, np.float32).reshape(-1)
               for m, x in zip(trees.leaves(mask), trees.leaves(tree)) if m]
        return np.concatenate(sel) if sel else np.zeros((0,), np.float32)

    return flat_adam_state_from_jax(count, flat(mu_tree), flat(nu_tree), device)


def state_on_mesh(tree_of_numpy: Any, mesh, min_rows: int = 16384, opt_state=None,
                  trainable_mask: Any = None, device=None, shard_experts: bool = False):
    """The JAX package's params (numpy; from a trainer with or without a
    mesh) -> one mesh rank's, as ``Trainer(mesh=)`` holds them: each
    ``user_emb`` / ``item_emb`` field table padded with zero rows to a
    multiple of the table axis (``pad_rows``), then this rank's slice kept of
    each leaf ``trainer_sharding.sharded_axes`` splits (the rows of a table
    the lookup shards, at least ``min_rows`` rows; with ``shard_experts``
    an expert bank's leading axis). Returns (params, axes), or (params,
    axes, FlatAdamState) given ``opt_state`` = (count, mu, nu) of a flat
    Adam over the whole padded tree and its ``trainable_mask`` (the
    optimizer's mask): the slots are cut to follow the slices. On
    ``device`` (default: the mesh rank's)."""
    from mamdr_tpu_torch.models.embeddings import lookup_row_sharded
    from mamdr_tpu_torch.parallel.embedding_shard import pad_rows
    from mamdr_tpu_torch.parallel.trainer_sharding import (
        shard_flat_slots,
        shard_tree,
        sharded_axes,
    )

    device = mesh.device if device is None else device

    def pad(name, x):
        x = torch.tensor(np.asarray(x))
        if lookup_row_sharded(name) and x.dim() == 2:
            n = pad_rows(x.shape[0], mesh.table)
            if n != x.shape[0]:
                x = torch.cat([x, x.new_zeros((n - x.shape[0], x.shape[1]))])
        return x

    whole = trees.named_tree_map(pad, tree_of_numpy)
    axes = sharded_axes(whole, mesh, min_rows, shard_experts)
    params = trees.tree_map(lambda x: x.to(device), shard_tree(whole, axes, mesh))
    if opt_state is None:
        return params, axes

    count, mu, nu = (torch.tensor(np.asarray(v)) for v in opt_state)
    sel = FlatAdam(0.0, trainable_mask)  # the optimizer's leaf selection
    mu, nu = (shard_flat_slots(v, whole, axes, sel, mesh) for v in (mu, nu))
    return params, axes, FlatAdamState(count=count.to(torch.int32).to(device),
                                       mu=mu.to(device), nu=nu.to(device))
