"""The MLP tower of the CTR zoo (reference deepctr.py:118-136).

Counterpart of ``mamdr_tpu/models/deepctr.py::MLP``: concatenated field
embeddings -> DNN -> bias-free logit. Its parameter tree has the flax names
(``embedding/{user,item,domain}_emb``, ``dnn/Dense_i/Dense_0/{kernel,bias}``,
``logit/Dense_0/Dense_0/kernel``). The other zoo models are later slices.

Training does not call ``forward``: the train step reads the parameter tree
and runs the fused tower kernel (ops/fused_mlp_step.py). ``apply`` runs the
forward pass on an explicit tree, as flax's ``model.apply`` does;
``apply_lanes`` is the evaluation forward of L towers at once, each lane
with its own parameters (the per-domain eval and the finetune lanes' val and
test).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from mamdr_tpu_torch.models.embeddings import EmbeddingBlock
from mamdr_tpu_torch.models.layers import DNN, LogitDense, dense_lanes
from mamdr_tpu_torch.ops.embedding_lookup import gather_fields
from mamdr_tpu_torch.utils import trees


class MLP(nn.Module):
    def __init__(self, n_uid: int, n_pid: int, n_domain: int,
                 user_dim: int = 128, item_dim: int = 128, domain_dim: int = 128,
                 hidden_dim: Sequence[int] = (256, 128, 64), dropout: float = 0.0,
                 pretrained_user: Optional[np.ndarray] = None,
                 pretrained_item: Optional[np.ndarray] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.user_dim, self.item_dim, self.domain_dim = user_dim, item_dim, domain_dim
        self.hidden_dim = tuple(int(h) for h in hidden_dim)
        self.dropout = float(dropout)
        self.embedding = EmbeddingBlock(
            n_uid, n_pid, n_domain, user_dim, item_dim, domain_dim,
            pretrained_user, pretrained_item, generator,
        )
        self.dnn = DNN(user_dim + item_dim + domain_dim, self.hidden_dim,
                       self.dropout, generator)
        self.logit = LogitDense(self.hidden_dim[-1], generator)

    def forward(self, uid, pid, domain, seeds=None) -> torch.Tensor:
        """Logits [B]. seeds: per-layer uint32 dropout seeds (training) or
        None (evaluation)."""
        return self.logit(self.dnn(self.embedding(uid, pid, domain), seeds))

    def param_tree(self):
        """The module's own parameters as a flax-named nested dict (detached
        views, not copies)."""
        return trees.unflatten(
            {name.replace(".", "/"): p.detach() for name, p in self.named_parameters()}
        )

    def apply(self, params, uid, pid, domain, seeds=None) -> torch.Tensor:
        """forward() with the parameters taken from `params` (a tree shaped
        like param_tree())."""
        flat = {name.replace("/", "."): leaf
                for name, leaf in trees.leaves_with_names(params)}
        return torch.func.functional_call(self, flat, (uid, pid, domain), {"seeds": seeds})

    @torch.no_grad()
    def apply_lanes(self, params, uid, pid, domain, gather=gather_fields) -> torch.Tensor:
        """Logits [L, B] of L towers without dropout; ids [L, B].

        ``params`` is shaped like param_tree(), each leaf with a leading lane
        axis or without one (a leaf every lane reads: the frozen user/item
        tables, or a weight all lanes share). The three fields come from ONE
        ``gather`` (kernel K2's wrapper by default; a check on the card passes
        the plain version) and each layer is one ``torch.baddbmm``. Runs
        under no_grad, so K2's autograd rule builds no graph.
        """
        emb = params["embedding"]
        x = gather((emb["user_emb"], emb["item_emb"], emb["domain_emb"]),
                   (uid, pid, domain))[0]
        for i in range(len(self.hidden_dim)):
            d = params["dnn"][f"Dense_{i}"]["Dense_0"]
            x = torch.relu(dense_lanes(x, d["kernel"], d["bias"]))
        return dense_lanes(x, params["logit"]["Dense_0"]["Dense_0"]["kernel"])[..., 0]
