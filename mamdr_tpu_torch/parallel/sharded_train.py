"""A self-contained sharded trainer: data-parallel batch, row-sharded tables.

Counterpart of ``mamdr_tpu/parallel/sharded_train.py``
(``make_sharded_train_step``, :69-140): the flagship MLP CTR tower with its
user and item tables row-sharded over the table group, the domain table and
the tower replicated, Adam, and the batch split over the data group. The
three fields come from one K2 launch with the row windows and one
``all_reduce`` over the table group (``embedding_shard.MeshLookup``); each
data rank computes its rows' loss normalised by the whole batch's weights,
and the gradients and the loss are summed over the data group in one
``all_reduce``. The init draws from a ``torch.Generator`` (jax.random
cannot be reproduced); ``params`` carries another init across, such as the
JAX package's (``convert.state_on_mesh``).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from mamdr_tpu_torch.models.layers import glorot_uniform
from mamdr_tpu_torch.parallel.data_feed import data_rows
from mamdr_tpu_torch.parallel.embedding_shard import MeshLookup, pad_rows, shard_range
from mamdr_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, all_reduce_sum_
from mamdr_tpu_torch.parallel.trainer_sharding import make_sharded_batch
from mamdr_tpu_torch.train.flat_optimizer import FlatAdam, true_on
from mamdr_tpu_torch.utils import trees


class ShardedState(NamedTuple):
    params: dict
    opt_state: tuple


def init_params(generator: torch.Generator, n_uid: int, n_pid: int, n_domain: int,
                dim: int, hidden: Sequence[int]) -> dict:
    """The whole tree, the JAX ``_init_params`` layout (``dense`` a dict of
    layers "0", "1", ...): tables N(0, 1) * 1e-4, Glorot-uniform kernels,
    zero biases, a bias-free logit."""
    def normal(shape):
        return torch.randn(shape, generator=generator) * 1e-4

    params = {"user_emb": normal((n_uid, dim)), "item_emb": normal((n_pid, dim)),
              "domain_emb": normal((n_domain, dim)), "dense": {}}
    in_dim = 3 * dim
    for i, h in enumerate(hidden):
        params["dense"][str(i)] = {"kernel": glorot_uniform(torch.empty(in_dim, h), generator),
                                   "bias": torch.zeros(h)}
        in_dim = h
    params["logit"] = {"kernel": glorot_uniform(torch.empty(in_dim, 1), generator)}
    return params


def make_sharded_train_step(mesh: Mesh, n_uid: int, n_pid: int, n_domain: int, batch: int,
                            hidden: Sequence[int] = (256, 128, 64), dim: int = 128,
                            learning_rate: float = 1e-3, seed: int = 0,
                            params: Optional[dict] = None):
    """(step, state, example batch) on this rank (JAX :69-140). The tables
    are padded to the table axis; ``params`` (a whole tree shaped like
    ``init_params``', numpy or tensors, tables at the padded rows) replaces
    the generator's draw. ``step(state, whole batch) -> (state, loss)``:
    the loss is the whole batch's, the same on every rank; a batch whose
    rows the data axis does not divide raises."""
    n_uid_p, n_pid_p = pad_rows(n_uid, mesh.table), pad_rows(n_pid, mesh.table)
    if params is None:
        params = init_params(torch.Generator().manual_seed(seed), n_uid_p, n_pid_p, n_domain,
                             dim, hidden)
    params = trees.tree_map(lambda x: torch.as_tensor(np.asarray(x)), params)
    for k, n in (("user_emb", n_uid_p), ("item_emb", n_pid_p)):
        if params[k].shape[0] != n:
            raise ValueError(f"{k} has {params[k].shape[0]} rows, the padded table {n}")
        params[k] = params[k][shard_range(mesh, n)].contiguous()
    params = trees.tree_map(lambda x: x.to(mesh.device), params)
    tx = FlatAdam(learning_rate, trees.tree_map(lambda x: True, params))
    has_data = true_on(mesh.device)
    state = ShardedState(params, tx.init(params))
    lookup = MeshLookup(mesh, (True, True, False))
    layers = [str(i) for i in range(len(params["dense"]))]

    def forward(p, b):
        x = lookup((p["user_emb"], p["item_emb"], p["domain_emb"]),
                   (b["uid"], b["pid"], b["domain"]))[0]
        for i in layers:
            x = torch.relu(x @ p["dense"][i]["kernel"] + p["dense"][i]["bias"])
        return (x @ p["logit"]["kernel"])[..., 0]

    def step(state: ShardedState, whole: Dict[str, torch.Tensor]):
        rows = data_rows(mesh, whole["uid"].shape[0])
        b = {k: v[rows] for k, v in whole.items()}
        live = trees.tree_map(lambda x: x.detach().requires_grad_(True), state.params)
        with torch.enable_grad():
            z = forward(live, b)
            bce = (-b["label"] * torch.nn.functional.logsigmoid(z)
                   - (1.0 - b["label"]) * torch.nn.functional.logsigmoid(-z))
            loss = torch.sum(bce * b["weight"]) / torch.clamp(torch.sum(whole["weight"]), min=1.0)
            grads = torch.autograd.grad(loss, trees.leaves(live))
        flat = all_reduce_sum_(mesh, torch.cat([g.reshape(-1) for g in grads]
                                               + [loss.detach().reshape(1)]), DATA_AXIS)
        pieces = iter(torch.split(flat[:-1], [g.numel() for g in grads]))
        gtree = trees.tree_map(lambda x: next(pieces).view(x.shape), state.params)
        return ShardedState(*tx.step(state.params, gtree, state.opt_state, has_data)), flat[-1]

    return step, state, make_sharded_batch(mesh, n_uid, n_pid, n_domain, batch)
