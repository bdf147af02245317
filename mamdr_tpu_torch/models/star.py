"""STAR: the star-topology multi-domain model, and its per-domain batch statistics.

Counterpart of ``mamdr_tpu/models/star.py`` (reference
model_zoo/Star/star.py:18-127):

  the three fields (ONE field gather, kernel K2 on the card) [B, 3D]
  -> {PartitionedNorm | BatchNorm | none}
  -> a plain Dense stack or a StarFCN stack (``dense``)
  -> (+ the AuxiliaryNet's output iff ``auxiliary_net``) -> Dense(1) with a bias.

Parameter paths are flax's: the tables at the top level
(``user_emb``, ``item_emb``, ``domain_emb``, drawn uniform(-0.05, 0.05) as
Keras' ``layers.Embedding`` draws them unless pretrained),
``star_fcn_i/{kernel,bias}_{shared,specific}``, ``dense_i/Dense_0/...``,
``partitioned_norm/{gamma,beta}_{shared,specific}``, ``bn/{scale,bias}``,
``auxiliary_net/{kernel,bias}_specific`` and ``head/Dense_0/{kernel,bias}``,
so the corpus's ``meta_parms`` filters (["emb", "kernel_shared",
"bias_shared"]) select the same leaves. The AuxiliaryNet's parameters always
exist; without ``auxiliary_net`` its output is not used, so it is not
computed and its gradient is zeros, as ``jax.grad`` gives.

The batch statistics are flax's ``batch_stats`` collection, a tree passed in
and returned, never a module buffer: ``partitioned_norm/{moving_mean,
moving_var}`` [n_domain, 3D] (zeros, ones), or ``bn/{mean, var}`` [3D]; none
without a norm (``init_stats``). In train mode a norm normalises with the
batch's own statistics — over every row of the batch, padding rows
included, as the JAX package takes them — and returns the new moving ones:
PartitionedNorm writes only row ``d`` (momentum 0.99), BatchNorm its whole
vectors; in eval mode both read them. PartitionedNorm's variance is
``jnp.var``'s (two passes), BatchNorm's flax's fast variance, E[x²] - E[x]²
clamped at 0. Epsilon 1e-3 for both.

The domain of a batch is ``domain[0]`` (a batch is one domain's). It stays
on the device: the per-domain rows are taken with ``index_select`` and the
moving statistics' row is written by a ``torch.where`` on a fresh tensor, so
the forward neither syncs with the host nor writes in place, and vmaps over
lanes (``apply_lanes``), each lane with its own domain.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from mamdr_tpu_torch.models.deepctr import ZooModel, _flat
from mamdr_tpu_torch.models.embeddings import FIELD_TABLES
from mamdr_tpu_torch.models.layers import Dense, glorot_uniform
from mamdr_tpu_torch.ops.embedding_lookup import gather_fields
from mamdr_tpu_torch.utils import trees

MOMENTUM = 0.99
EPSILON = 1e-3


def keras_embedding_init(t: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Keras ``layers.Embedding``'s default: uniform(-0.05, 0.05)."""
    return t.uniform_(-0.05, 0.05, generator=generator)


def _param(shape, init, generator) -> nn.Parameter:
    return nn.Parameter(init(torch.empty(shape), generator))


def _ones(shape) -> nn.Parameter:
    return nn.Parameter(torch.ones(shape))


def _zeros(shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape))


def _row(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[d] for the batch's domain idx [1], on the device."""
    return torch.index_select(table, 0, idx)[0]


class StarFCN(nn.Module):
    """relu(x @ (kernel_shared * kernel_specific[d]) + bias_shared +
    bias_specific[d]) (reference star_fcn.py:105-123)."""

    def __init__(self, n_domain: int, in_features: int, units: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel_specific = _param((n_domain, in_features, units), glorot_uniform, generator)
        self.bias_specific = _zeros((n_domain, units))
        self.kernel_shared = _param((in_features, units), glorot_uniform, generator)
        self.bias_shared = _zeros((units,))

    def forward(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        kernel = self.kernel_shared * _row(self.kernel_specific, idx)
        bias = self.bias_shared + _row(self.bias_specific, idx)
        return torch.relu(x @ kernel + bias)


class AuxiliaryNet(nn.Module):
    """relu(x @ kernel_specific[d] + bias_specific[d]), purely domain-specific
    (reference auxiliary_net.py:61-101)."""

    def __init__(self, n_domain: int, in_features: int, units: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel_specific = _param((n_domain, in_features, units), glorot_uniform, generator)
        self.bias_specific = _zeros((n_domain, units))

    def forward(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        return torch.relu(x @ _row(self.kernel_specific, idx) + _row(self.bias_specific, idx))


class PartitionedNorm(nn.Module):
    """Per-domain batch norm (reference partitioned_norm.py:13-203): gamma =
    gamma_shared * gamma_specific[d], beta = beta_shared + beta_specific[d];
    moving statistics one row a domain."""

    def __init__(self, n_domain: int, dim: int):
        super().__init__()
        self.n_domain, self.dim = n_domain, dim
        self.gamma_specific = _ones((n_domain, dim))
        self.beta_specific = _zeros((n_domain, dim))
        self.gamma_shared = _ones((dim,))
        self.beta_shared = _zeros((dim,))

    def init_stats(self):
        return {"moving_mean": torch.zeros((self.n_domain, self.dim)),
                "moving_var": torch.ones((self.n_domain, self.dim))}

    def forward(self, x: torch.Tensor, idx: torch.Tensor, stats, train: bool):
        """(y, new stats): in train mode row d of the moving statistics moves
        toward the batch's; otherwise they are read and returned as given."""
        gamma = self.gamma_shared * _row(self.gamma_specific, idx)
        beta = self.beta_shared + _row(self.beta_specific, idx)
        mm, mv = stats["moving_mean"], stats["moving_var"]
        if train:
            mean = torch.mean(x, dim=0)
            centered = x - mean
            var = torch.mean(centered * centered, dim=0)
            at_d = (torch.arange(self.n_domain, device=x.device) == idx)[:, None]
            stats = {
                "moving_mean": torch.where(at_d, _row(mm, idx) * MOMENTUM
                                           + mean * (1.0 - MOMENTUM), mm),
                "moving_var": torch.where(at_d, _row(mv, idx) * MOMENTUM
                                          + var * (1.0 - MOMENTUM), mv),
            }
        else:
            mean, var = _row(mm, idx), _row(mv, idx)
        return (x - mean) * torch.rsqrt(var + EPSILON) * gamma + beta, stats


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.99, epsilon=1e-3)`` over the batch axis:
    params ``scale`` / ``bias``, statistics ``mean`` / ``var``."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.scale = _ones((dim,))
        self.bias = _zeros((dim,))

    def init_stats(self):
        return {"mean": torch.zeros((self.dim,)), "var": torch.ones((self.dim,))}

    def forward(self, x: torch.Tensor, idx: torch.Tensor, stats, train: bool):
        if train:
            mean = torch.mean(x, dim=0)
            var = torch.clamp(torch.mean(x * x, dim=0) - mean * mean, min=0.0)
            stats = {"mean": MOMENTUM * stats["mean"] + (1.0 - MOMENTUM) * mean,
                     "var": MOMENTUM * stats["var"] + (1.0 - MOMENTUM) * var}
        else:
            mean, var = stats["mean"], stats["var"]
        return (x - mean) * (torch.rsqrt(var + EPSILON) * self.scale) + self.bias, stats


class Star(ZooModel):
    """The STAR model (reference star.py:70-96); see the module docstring.

    ``apply`` / ``apply_lanes`` take the batch statistics (``stats``) and
    ``train``: in train mode they return (logits, new stats), otherwise the
    logits. ``n_dropout_sites`` is 0: STAR has no dropout."""

    def __init__(self, n_uid: int, n_pid: int, n_domain: int,
                 user_dim: int = 128, item_dim: int = 128, domain_dim: int = 128,
                 hidden_dim: Sequence[int] = (256, 128, 64), auxiliary_dim: int = 128,
                 norm: str = "none", dense: str = "dense", auxiliary_net: bool = False,
                 pretrained_user: Optional[np.ndarray] = None,
                 pretrained_item: Optional[np.ndarray] = None,
                 generator: Optional[torch.Generator] = None):
        # flax's Star keeps its tables at the top level, not in ZooModel's
        # embedding block, so ZooModel.__init__ is not run
        nn.Module.__init__(self)
        if norm not in ("pn", "bn", "none"):
            raise ValueError(f"norm must be pn, bn or none, got {norm!r}")
        if dense not in ("star", "dense"):
            raise ValueError(f"dense must be star or dense, got {dense!r}")
        self.n_domain = n_domain
        self.dims = (user_dim, item_dim, domain_dim)
        self.hidden_dim = tuple(int(h) for h in hidden_dim)
        self.dropout = 0.0
        self.dense, self.add_auxiliary = dense, bool(auxiliary_net)
        # the norm's module name, which is also its key in the statistics tree
        self.norm_name = {"pn": "partitioned_norm", "bn": "bn"}.get(norm)
        self.has_batch_stats = self.norm_name is not None
        self._ranks = None

        def table(pre, shape):
            if pre is None:
                return _param(shape, keras_embedding_init, generator)
            if tuple(pre.shape) != tuple(shape):
                raise ValueError(f"pretrained shape {pre.shape} != {shape}")
            # shares the caller's buffer: parameters are never written in place
            return nn.Parameter(torch.from_numpy(np.asarray(pre, np.float32)))

        self.user_emb = table(pretrained_user, (n_uid, user_dim))
        self.item_emb = table(pretrained_item, (n_pid, item_dim))
        self.domain_emb = _param((n_domain, domain_dim), keras_embedding_init, generator)
        width = self.in_features
        if norm == "pn":
            self.partitioned_norm = PartitionedNorm(n_domain, width)
        elif norm == "bn":
            self.bn = BatchNorm(width)
        self.auxiliary_net = AuxiliaryNet(n_domain, width, auxiliary_dim, generator)
        prev = width
        for i, units in enumerate(self.hidden_dim):
            if dense == "star":
                setattr(self, f"star_fcn_{i}", StarFCN(n_domain, prev, units, generator))
            else:
                setattr(self, f"dense_{i}", Dense(prev, units, generator=generator))
            prev = units
        if self.add_auxiliary and prev != auxiliary_dim:
            raise ValueError(f"auxiliary_net adds a width-{auxiliary_dim} output to the "
                             f"tower's width {prev}")
        self.head = Dense(prev, 1, generator=generator)

    @property
    def n_dropout_sites(self) -> int:
        return 0

    def init_stats(self):
        """The initial batch statistics, on the CPU: {} without a norm."""
        if not self.has_batch_stats:
            return {}
        return {self.norm_name: getattr(self, self.norm_name).init_stats()}

    def gather_inputs(self, params, uid, pid, domain, gather=gather_fields):
        """(x [*ids.shape, 3D], None): the three top-level tables by ONE
        ``gather``; no wide term."""
        x = gather(tuple(params[k] for k in FIELD_TABLES), (uid, pid, domain))[0]
        return x, None

    def forward(self, uid, pid, domain, seeds=None, fields=None, stats=None,
                train: bool = False):
        """Logits [B], or (logits, new stats) in train mode with a norm."""
        if fields is None:
            fields = self.gather_inputs(dict(self.named_parameters()), uid, pid, domain)
        x = fields[0]
        idx = domain[:1].long()
        if self.has_batch_stats:
            if stats is None:
                raise ValueError(f"{self.norm_name} needs the batch statistics")
            x, new = getattr(self, self.norm_name)(x, idx, stats[self.norm_name], train)
            stats = {self.norm_name: new}
        aux = self.auxiliary_net(x, idx) if self.add_auxiliary else None
        for i in range(len(self.hidden_dim)):
            if self.dense == "star":
                x = getattr(self, f"star_fcn_{i}")(x, idx)
            else:
                x = torch.relu(getattr(self, f"dense_{i}")(x))
        if aux is not None:
            x = x + aux
        logits = self.head(x)[..., 0]
        return (logits, stats) if train and self.has_batch_stats else logits

    def apply(self, params, uid, pid, domain, seeds=None, gather=gather_fields,
              stats=None, train: bool = False):
        """forward() with the parameters taken from `params`."""
        fields = self.gather_inputs(params, uid, pid, domain, gather)
        return torch.func.functional_call(
            self, _flat(params), (uid, pid, domain),
            {"fields": fields, "stats": stats, "train": train})

    def stats_axes(self, stats):
        """0 at each leaf of `stats` that carries a lane axis (one rank more
        than the leaf of ``init_stats()``), None at a leaf every lane reads."""
        ranks = {n: x.dim() for n, x in trees.leaves_with_names(self.init_stats())}

        def axis(name, x):
            if x.dim() not in (ranks[name], ranks[name] + 1):
                raise ValueError(f"{name}: rank {x.dim()}, the model's is {ranks[name]}")
            return 0 if x.dim() == ranks[name] + 1 else None

        return trees.named_tree_map(axis, stats)

    def apply_lanes(self, params, uid, pid, domain, gather=gather_fields, seeds=None,
                    stats=None, train: bool = False):
        """Logits [L, B] of L towers over ids [L, B] — or, in train mode with
        a norm, (logits, new stats [L]-stacked). ``params`` and ``stats``
        leaves carry a leading lane axis or not (``lane_axes``,
        ``stats_axes``); every lane reads the statistics of its own batch's
        domain."""
        x = self.gather_inputs(params, uid, pid, domain, gather)[0]
        tower = {k: v for k, v in params.items() if k not in FIELD_TABLES}
        axes = self.lane_axes(tower)
        stats = stats if self.has_batch_stats else None
        s_axes = None if stats is None else self.stats_axes(stats)

        def one(p, x, dom, st):
            return torch.func.functional_call(self, p, (None, None, dom),
                                              {"fields": (x, None), "stats": st,
                                               "train": train})

        return torch.func.vmap(one, in_dims=(_flat(axes), 0, 0, s_axes))(
            _flat(tower), x, domain, stats)
