"""The single-tower CTR zoo: MLP, WDL, DeepFM, NFM, AutoInt, CCPM and PNN.

Counterpart of ``mamdr_tpu/models/deepctr.py`` (reference
model_zoo/DeepCTR/deepctr.py:16-136). Every model maps (uid, pid, domain) id
batches to one click logit; the sigmoid lives in the loss. Parameter trees
have the flax names (``embedding/{user,item,domain}_emb``,
``linear/linear_{user,item,domain}_emb``, ``dnn/Dense_i/Dense_0/{kernel,bias}``,
``logit/Dense_0/Dense_0/kernel``, ``interacting_i/{query,key,value,res}``,
``conv_i/{kernel,bias}``, ``outer_product/kernel``).

``ZooModel`` is what every base model of the port shares (the MTL models of
``models/mtl.py`` too):

  - the inputs come from ``gather_inputs``: the three fields from ONE field
    gather (kernel K2 on the card, differentiable in the tables through its
    autograd rule) as x [..., 3D], and the wide term's dim-1 rows where the
    model has one;
  - ``forward(uid, pid, domain, seeds, fields)`` is the tower on those
    inputs; ``apply`` runs it on an explicit parameter tree, as flax's
    ``model.apply`` does;
  - ``apply_lanes`` is the forward of L towers at once over ids [L, B], each
    lane with its own parameters: the gathers take the lane-stacked tables
    directly, and the tower is ``torch.func.vmap`` of ``forward`` over the
    lane axis of the leaves that have one. Whether a leaf has a lane axis is
    decided against the rank of the same leaf in the model's own
    ``param_tree()`` (``lane_axes``), never by a fixed rank: an MTL tower
    kernel is rank 3 without lanes. It is differentiable (the autograd lane
    step, train/steps.py) and runs without a graph under ``no_grad`` (the
    lane eval);
  - ``compute_dtype`` ("float32" or "bfloat16"; JAX deepctr.py:64-71): the
    dtype of the DNN's and the logit head's products (flax ``nn.Dense``'s
    ``dtype``, models/layers.py); the tables, the wide and FM terms, the
    attention and conv layers, the loss and the metrics stay float32, and
    the parameters are float32 either way. The MTL models and STAR accept
    the key and compute in float32, as the JAX package's do;
  - ``n_dropout_sites``: how many hash-dropout layers a forward passes
    through, in call order; a train step draws that many seeds
    (``fast_random.step_seeds``) and ``forward`` hands them out in the order
    flax calls the layers, so the masks equal the JAX package's for the same
    seeds.

Training the plain MLP on the plain loss does not call ``forward``: its
train step reads the parameter tree and runs the fused tower kernel
(ops/fused_mlp_step.py).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from mamdr_tpu_torch.models.embeddings import (
    EmbeddingBlock,
    LinearEmbeddingBlock,
    linear_logit,
    stack_fields,
)
from mamdr_tpu_torch.models.layers import (
    DNN,
    Conv,
    InteractingLayer,
    LogitDense,
    OuterProduct,
    bi_interaction,
    dense_dtype,
    fm_interaction,
    inner_product,
    k_max_pooling,
)
from mamdr_tpu_torch.ops.embedding_lookup import gather_fields
from mamdr_tpu_torch.utils import trees

_INPUTS = ("embedding", "linear")  # the subtrees gather_inputs reads


def _flat(tree):
    """A parameter tree as functional_call's {module.path: tensor}."""
    return {name.replace("/", "."): leaf for name, leaf in trees.leaves_with_names(tree)}


class ZooModel(nn.Module):
    """The embedding tables and what every base model shares (see the module
    docstring). Subclasses build their layers after ``__init__`` and define
    ``tower`` and ``n_dropout_sites``."""

    has_linear = False  # a wide term of dim-1 tables
    has_batch_stats = False  # STAR's norms carry moving statistics (models/star.py)
    compute_dtype = "float32"  # the DNN's and logit head's (the deepctr bases)

    def __init__(self, n_uid: int, n_pid: int, n_domain: int,
                 user_dim: int = 128, item_dim: int = 128, domain_dim: int = 128,
                 hidden_dim: Sequence[int] = (256, 128, 64), dropout: float = 0.0,
                 pretrained_user: Optional[np.ndarray] = None,
                 pretrained_item: Optional[np.ndarray] = None,
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: str = "float32"):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.cdtype = dense_dtype(compute_dtype)
        self.n_domain = n_domain
        self.user_dim, self.item_dim, self.domain_dim = user_dim, item_dim, domain_dim
        self.dims = (user_dim, item_dim, domain_dim)
        self.hidden_dim = tuple(int(h) for h in hidden_dim)
        self.dropout = float(dropout)
        self.embedding = EmbeddingBlock(
            n_uid, n_pid, n_domain, user_dim, item_dim, domain_dim,
            pretrained_user, pretrained_item, generator,
        )
        if self.has_linear:
            self.linear = LinearEmbeddingBlock(n_uid, n_pid, n_domain, generator)
        self._ranks = None

    @property
    def in_features(self) -> int:
        return sum(self.dims)

    @property
    def n_dropout_sites(self) -> int:
        raise NotImplementedError

    def init_stats(self):
        """The initial batch statistics: none for a model without a norm."""
        return {}

    def tower(self, x, lin, domain, seeds):
        """Logits [B] from the gathered inputs: x [B, 3D] and the wide term
        lin [B] (None without one); ``seeds`` [n_dropout_sites] or None."""
        raise NotImplementedError

    def gather_inputs(self, params, uid, pid, domain, gather=gather_fields):
        """(x [*ids.shape, 3D], lin [*ids.shape] or None): the fields by ONE
        ``gather`` (K2's wrapper by default; a check on the card passes its
        plain version) and the wide term by plain indexing. Tables [N, D] or
        lane-stacked [L, N, D] with ids [L, B]."""
        emb = params["embedding"]
        x = gather((emb["user_emb"], emb["item_emb"], emb["domain_emb"]),
                   (uid, pid, domain))[0]
        lin = linear_logit(params["linear"], uid, pid, domain) if self.has_linear else None
        return x, lin

    def forward(self, uid, pid, domain, seeds=None, fields=None) -> torch.Tensor:
        """Logits [B]. seeds: uint32 dropout seeds, one a dropout site
        (training), or None (evaluation). fields: the gathered (x, lin), when
        the caller took them (``apply``, ``apply_lanes``)."""
        if fields is None:
            fields = self.gather_inputs(
                {k: dict(getattr(self, k).named_parameters()) for k in _INPUTS
                 if hasattr(self, k)}, uid, pid, domain)
        return self.tower(*fields, domain, seeds)

    def param_tree(self):
        """The module's own parameters as a flax-named nested dict (detached
        views, not copies)."""
        return trees.unflatten(
            {name.replace(".", "/"): p.detach() for name, p in self.named_parameters()}
        )

    def apply(self, params, uid, pid, domain, seeds=None, gather=gather_fields) -> torch.Tensor:
        """forward() with the parameters taken from `params` (a tree shaped
        like param_tree())."""
        fields = self.gather_inputs(params, uid, pid, domain, gather)
        return torch.func.functional_call(self, _flat(params), (uid, pid, domain),
                                          {"seeds": seeds, "fields": fields})

    def lane_axes(self, params):
        """0 at each leaf of `params` (a subtree of param_tree()'s shape, or
        the whole) that carries a leading lane axis — one rank more than the
        leaf of param_tree() — and None at a leaf every lane reads."""
        if self._ranks is None:
            self._ranks = {n.replace(".", "/"): p.dim() for n, p in self.named_parameters()}

        def axis(name, x):
            rank = self._ranks[name]
            if x.dim() not in (rank, rank + 1):
                raise ValueError(f"{name}: rank {x.dim()}, the model's is {rank}")
            return 0 if x.dim() == rank + 1 else None

        return trees.named_tree_map(axis, params)

    def apply_lanes(self, params, uid, pid, domain, gather=gather_fields,
                    seeds=None) -> torch.Tensor:
        """Logits [L, B] of L towers; ids [L, B]; seeds [L, n_dropout_sites]
        (a lane's own dropout) or None (no dropout).

        ``params`` is shaped like param_tree(), each leaf with a leading lane
        axis or without one (``lane_axes``: a leaf every lane reads, such as
        the frozen user/item tables). The three fields come from ONE
        ``gather`` over every lane; the tower is vmapped over the lanes.
        Differentiable in every leaf that requires a gradient.
        """
        fields = self.gather_inputs(params, uid, pid, domain, gather)
        tower = {k: v for k, v in params.items() if k not in _INPUTS}
        axes = self.lane_axes(tower)

        def one(p, x, lin, dom, s):
            return torch.func.functional_call(self, p, (None, None, dom),
                                              {"seeds": s, "fields": (x, lin)})

        x, lin = fields
        return torch.func.vmap(one, in_dims=(
            _flat(axes), 0, None if lin is None else 0, 0, None if seeds is None else 0,
        ))(_flat(tower), x, lin, domain, seeds)


class MLP(ZooModel):
    """In-repo MLP: concatenated field embeddings -> DNN -> bias-free logit
    (reference deepctr.py:118-136)."""

    def __init__(self, n_uid: int, n_pid: int, n_domain: int,
                 user_dim: int = 128, item_dim: int = 128, domain_dim: int = 128,
                 hidden_dim: Sequence[int] = (256, 128, 64), dropout: float = 0.0,
                 pretrained_user: Optional[np.ndarray] = None,
                 pretrained_item: Optional[np.ndarray] = None,
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: str = "float32"):
        super().__init__(n_uid, n_pid, n_domain, user_dim, item_dim, domain_dim, hidden_dim,
                         dropout, pretrained_user, pretrained_item, generator, compute_dtype)
        self.dnn = DNN(self.in_features, self.hidden_dim, self.dropout, generator, self.cdtype)
        self.logit = LogitDense(self.hidden_dim[-1], generator, self.cdtype)

    @property
    def n_dropout_sites(self) -> int:
        return len(self.hidden_dim)

    def tower(self, x, lin, domain, seeds):
        return self.logit(self.dnn(x, seeds))


class _DNNLogit(ZooModel):
    """A model whose tower ends in ``dnn`` -> ``logit``."""

    def _dnn_logit(self, dnn_in: int, logit_extra: int, generator):
        self.dnn = DNN(dnn_in, self.hidden_dim, self.dropout, generator, self.cdtype)
        self.logit = LogitDense(self.hidden_dim[-1] + logit_extra, generator, self.cdtype)

    @property
    def n_dropout_sites(self) -> int:
        return len(self.hidden_dim)


class WDL(_DNNLogit):
    """Wide & Deep: linear logits + DNN logit."""

    has_linear = True

    def __init__(self, *args, generator=None, **kw):
        super().__init__(*args, generator=generator, **kw)
        self._dnn_logit(self.in_features, 0, generator)

    def tower(self, x, lin, domain, seeds):
        return lin + self.logit(self.dnn(x, seeds))


class DeepFM(_DNNLogit):
    """linear + FM second-order term + DNN over the concatenated fields."""

    has_linear = True

    def __init__(self, *args, generator=None, **kw):
        super().__init__(*args, generator=generator, **kw)
        self._dnn_logit(self.in_features, 0, generator)

    def tower(self, x, lin, domain, seeds):
        fields = stack_fields(x, self.dims)
        return lin + fm_interaction(fields) + self.logit(self.dnn(x, seeds))


class NFM(_DNNLogit):
    """linear + DNN over the bi-interaction pooled fields."""

    has_linear = True

    def __init__(self, *args, generator=None, **kw):
        super().__init__(*args, generator=generator, **kw)
        self._dnn_logit(self.domain_dim, 0, generator)

    def tower(self, x, lin, domain, seeds):
        pooled = bi_interaction(stack_fields(x, self.dims))
        return lin + self.logit(self.dnn(pooled, seeds))


class AutoInt(_DNNLogit):
    """Stacked multi-head self-attention over the fields beside a DNN; the
    logit reads both (deepctr AutoInt: 3 layers, 4 heads of 8, reference
    deepctr.py:37-39)."""

    has_linear = True

    def __init__(self, *args, att_head_num: int = 4, att_layer_num: int = 3,
                 att_embedding_size: int = 8, generator=None, **kw):
        super().__init__(*args, generator=generator, **kw)
        self.att_layer_num = att_layer_num
        d_in, unit = self.domain_dim, att_embedding_size * att_head_num
        for i in range(att_layer_num):
            setattr(self, f"interacting_{i}", InteractingLayer(
                d_in, att_embedding_size, att_head_num, generator=generator))
            d_in = unit
        self._dnn_logit(self.in_features, len(self.dims) * d_in, generator)

    def tower(self, x, lin, domain, seeds):
        att = stack_fields(x, self.dims)
        for i in range(self.att_layer_num):
            att = getattr(self, f"interacting_{i}")(att)
        att = att.reshape(att.shape[0], -1)
        deep = self.dnn(x, seeds)
        return lin + self.logit(torch.cat([att, deep], dim=-1))


class CCPM(_DNNLogit):
    """Convolutional click prediction: convs over the field axis, each
    followed by tanh and k-max pooling, then a DNN. With 3 fields a conv's
    width is clamped to the fields left; p-max pooling follows CCPM's
    schedule k_i = max(1, int((1 - (i/l)^(l-i)) * 3)), the last k = 3,
    each k at most the fields left."""

    has_linear = True

    def __init__(self, *args, conv_kernel_width: Sequence[int] = (6, 5),
                 conv_filters: Sequence[int] = (4, 4), generator=None, **kw):
        super().__init__(*args, generator=generator, **kw)
        n_fields = len(self.dims)
        l_ = len(conv_filters)
        self.ks = []
        f, c = n_fields, 1
        for i, (width, filters) in enumerate(zip(conv_kernel_width, conv_filters)):
            setattr(self, f"conv_{i}", Conv(c, filters, min(width, f), generator))
            if i < l_ - 1:
                k = max(1, int((1 - (float(i + 1) / l_) ** (l_ - i - 1)) * n_fields))
            else:
                k = 3
            k = min(k, f)
            self.ks.append(k)
            f, c = k, filters
        self._dnn_logit(f * self.domain_dim * c, 0, generator)

    def tower(self, x, lin, domain, seeds):
        h = stack_fields(x, self.dims)[..., None]  # [B, F, D, 1] NHWC
        for i, k in enumerate(self.ks):
            h = k_max_pooling(torch.tanh(getattr(self, f"conv_{i}")(h)), k, dim=1)
        h = h.reshape(h.shape[0], -1)
        return lin + self.logit(self.dnn(h, seeds))


class PNN(_DNNLogit):
    """Product-based NN: [fields, inner products, outer products] -> DNN ->
    logit, no wide term (the reference calls models.PNN with its defaults,
    deepctr.py:45-46)."""

    def __init__(self, *args, use_inner: bool = True, use_outter: bool = False,
                 generator=None, **kw):
        super().__init__(*args, generator=generator, **kw)
        self.use_inner, self.use_outter = use_inner, use_outter
        n_fields = len(self.dims)
        n_pairs = n_fields * (n_fields - 1) // 2
        if use_outter:
            self.outer_product = OuterProduct(n_fields, self.domain_dim, generator)
        self._dnn_logit(self.in_features + n_pairs * (use_inner + use_outter), 0, generator)

    def tower(self, x, lin, domain, seeds):
        fields = stack_fields(x, self.dims)
        parts = [x]
        if self.use_inner:
            parts.append(inner_product(fields))
        if self.use_outter:
            parts.append(self.outer_product(fields))
        return self.logit(self.dnn(torch.cat(parts, dim=-1), seeds))
