"""Multi-task CTR models: SharedBottom, MMoE and PLE, one task a domain.

Counterpart of ``mamdr_tpu/models/mtl.py`` (reference
model_zoo/DeepMTLCTR/deep_mtl_ctr.py:17-233). Every forward computes ALL T
task towers batched on a leading task axis ([T, ...] einsums) and selects
the logit of the batch's domain, ``domain[0]`` (a batch is one domain's;
``select_head``). In a lane forward (``ZooModel.apply_lanes``) each lane
selects by its own ``domain[:, 0]``.

Parameter trees keep the flax names: ``towers/tower_{kernel,bias}_i``,
``towers/tower_logit``, ``experts/expert_{kernel,bias}_i``, ``gate_kernel``,
``gate_dnn/Dense_i/Dense_0/...``, ``bottom_dnn/...``, and PLE's
``{task,shared}_expert_{kernel,bias}_l``, ``task_gate_kernel_l`` and
``shared_gate_kernel_l``. Kernels of rank 3 and 4 are drawn with flax's
fans (``layers.fans``: the receptive field counts). Dropout sites, in flax's
call order: SharedBottom the bottom DNN's layers then the towers'; MMoE the
experts', the gate DNN's, then the towers'; PLE the towers' only.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from mamdr_tpu_torch.models.deepctr import ZooModel
from mamdr_tpu_torch.models.layers import DNN, FastDropout, glorot_normal, glorot_uniform


def _param(shape, init, generator) -> nn.Parameter:
    return nn.Parameter(init(torch.empty(shape), generator))


def _zeros(shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape))


def _seeds(seeds, start: int, stop: int):
    return None if seeds is None else seeds[start:stop]


def select_head(all_logits: torch.Tensor, domain: torch.Tensor) -> torch.Tensor:
    """[T, B] and the batch's domain ids [B] -> [B]: the task of domain[0]."""
    return torch.index_select(all_logits, 0, domain[:1].long())[0]


class TaskTowers(nn.Module):
    """All T task towers in one batched einsum: x [B, Din] (shared) or
    [T, B, Din] (a task's own) -> [T, B] logits."""

    def __init__(self, n_task: int, in_features: int, hidden: Sequence[int],
                 dropout: float = 0.0, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_task, self.n_layers = n_task, len(hidden)
        prev = in_features
        for li, units in enumerate(hidden):
            setattr(self, f"tower_kernel_{li}",
                    _param((n_task, prev, units), glorot_uniform, generator))
            setattr(self, f"tower_bias_{li}", _zeros((n_task, units)))
            prev = units
        self.tower_logit = _param((n_task, prev, 1), glorot_normal, generator)
        self.dropout = FastDropout(dropout)

    def forward(self, x: torch.Tensor, seeds=None) -> torch.Tensor:
        if x.dim() == 2:
            x = x.expand(self.n_task, *x.shape)
        for li in range(self.n_layers):
            w, b = getattr(self, f"tower_kernel_{li}"), getattr(self, f"tower_bias_{li}")
            x = torch.relu(torch.einsum("tbi,tio->tbo", x, w) + b[:, None, :])
            x = self.dropout(x, None if seeds is None else seeds[li])
        return torch.einsum("tbi,tio->tbo", x, self.tower_logit)[..., 0]


class ExpertBank(nn.Module):
    """E expert DNNs batched on the expert axis: [B, Din] -> [E, B, Dout]."""

    def __init__(self, n_expert: int, in_features: int, hidden: Sequence[int],
                 dropout: float = 0.0, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_expert, self.n_layers = n_expert, len(hidden)
        prev = in_features
        for li, units in enumerate(hidden):
            setattr(self, f"expert_kernel_{li}",
                    _param((n_expert, prev, units), glorot_uniform, generator))
            setattr(self, f"expert_bias_{li}", _zeros((n_expert, units)))
            prev = units
        self.dropout = FastDropout(dropout)

    def forward(self, x: torch.Tensor, seeds=None) -> torch.Tensor:
        x = x.expand(self.n_expert, *x.shape)
        for li in range(self.n_layers):
            w, b = getattr(self, f"expert_kernel_{li}"), getattr(self, f"expert_bias_{li}")
            x = torch.relu(torch.einsum("ebi,eio->ebo", x, w) + b[:, None, :])
            x = self.dropout(x, None if seeds is None else seeds[li])
        return x


class _MTLBase(ZooModel):
    """The MTL models' attributes (``mamdr_tpu/models/mtl.py`` ``_MTLBase``):
    the tower input is the gathered x [B, 3D] itself."""

    def __init__(self, n_uid: int, n_pid: int, n_domain: int,
                 user_dim: int = 128, item_dim: int = 128, domain_dim: int = 128,
                 hidden_dim: Sequence[int] = (512, 256, 128),
                 tower_hidden_dim: Sequence[int] = (64,), dropout: float = 0.0,
                 num_experts: int = 4, gate_dnn_hidden_units: Sequence[int] = (),
                 specific_expert_num: int = 1, shared_expert_num: int = 1,
                 num_levels: int = 2, pretrained_user=None, pretrained_item=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(n_uid, n_pid, n_domain, user_dim, item_dim, domain_dim, hidden_dim,
                         dropout, pretrained_user, pretrained_item, generator)
        self.tower_hidden_dim = tuple(int(h) for h in tower_hidden_dim)
        self.num_experts = num_experts
        self.gate_dnn_hidden_units = tuple(int(h) for h in gate_dnn_hidden_units)
        self.specific_expert_num, self.shared_expert_num = specific_expert_num, shared_expert_num
        self.num_levels = num_levels

    def _towers(self, in_features: int, generator):
        self.towers = TaskTowers(self.n_domain, in_features, self.tower_hidden_dim,
                                 self.dropout, generator)


class SharedBottom(_MTLBase):
    """Shared bottom DNN -> per-task towers (deep_mtl_ctr.py:26-30)."""

    def __init__(self, *args, generator=None, **kw):
        super().__init__(*args, generator=generator, **kw)
        self.bottom_dnn = DNN(self.in_features, self.hidden_dim, self.dropout, generator)
        self._towers(self.hidden_dim[-1], generator)

    @property
    def n_dropout_sites(self) -> int:
        return len(self.hidden_dim) + len(self.tower_hidden_dim)

    def tower(self, x, lin, domain, seeds):
        nb = len(self.hidden_dim)
        h = self.bottom_dnn(x, _seeds(seeds, 0, nb))
        return select_head(self.towers(h, _seeds(seeds, nb, None)), domain)


class MMoE(_MTLBase):
    """Multi-gate mixture of experts: per-task softmax gates over a shared
    expert bank, then the task towers (deep_mtl_ctr.py:31-38)."""

    def __init__(self, *args, generator=None, **kw):
        super().__init__(*args, generator=generator, **kw)
        self.experts = ExpertBank(self.num_experts, self.in_features, self.hidden_dim,
                                  self.dropout, generator)
        gate_in = self.in_features
        if self.gate_dnn_hidden_units:
            self.gate_dnn = DNN(self.in_features, self.gate_dnn_hidden_units, self.dropout,
                                generator)
            gate_in = self.gate_dnn_hidden_units[-1]
        self.gate_kernel = _param((self.n_domain, gate_in, self.num_experts), glorot_uniform,
                                  generator)
        self._towers(self.hidden_dim[-1], generator)

    @property
    def n_dropout_sites(self) -> int:
        return (len(self.hidden_dim) + len(self.gate_dnn_hidden_units)
                + len(self.tower_hidden_dim))

    def tower(self, x, lin, domain, seeds):
        ne, ng = len(self.hidden_dim), len(self.gate_dnn_hidden_units)
        experts = self.experts(x, _seeds(seeds, 0, ne))  # [E, B, D]
        gate_in = x
        if self.gate_dnn_hidden_units:
            gate_in = self.gate_dnn(gate_in, _seeds(seeds, ne, ne + ng))
        gates = torch.softmax(torch.einsum("bi,tie->tbe", gate_in, self.gate_kernel), dim=-1)
        mixed = torch.einsum("tbe,ebd->tbd", gates, experts)  # [T, B, D]
        return select_head(self.towers(mixed, _seeds(seeds, ne + ng, None)), domain)


class PLE(_MTLBase):
    """Progressive Layered Extraction: CGC stacked ``num_levels`` times. Per
    level each task has ``specific_expert_num`` experts of its own and
    ``shared_expert_num`` shared ones; a task's gate mixes its own and the
    shared experts, the shared path's gate mixes all of them; the last
    level feeds the task towers (deep_mtl_ctr.py:39-48)."""

    def __init__(self, *args, generator=None, **kw):
        super().__init__(*args, generator=generator, **kw)
        T, t, s = self.n_domain, self.specific_expert_num, self.shared_expert_num
        d_task = d_shared = self.in_features
        for level in range(self.num_levels):
            h = self.hidden_dim[min(level, len(self.hidden_dim) - 1)]
            for name, shape, init in (
                (f"task_expert_kernel_{level}", (T, t, d_task, h), glorot_uniform),
                (f"task_expert_bias_{level}", (T, t, h), None),
                (f"shared_expert_kernel_{level}", (s, d_shared, h), glorot_uniform),
                (f"shared_expert_bias_{level}", (s, h), None),
                (f"task_gate_kernel_{level}", (T, d_task, t + s), glorot_uniform),
                (f"shared_gate_kernel_{level}", (d_shared, T * t + s), glorot_uniform),
            ):
                setattr(self, name, _zeros(shape) if init is None
                        else _param(shape, init, generator))
            d_task = d_shared = h
        self._towers(d_task, generator)

    @property
    def n_dropout_sites(self) -> int:
        return len(self.tower_hidden_dim)

    def tower(self, x, lin, domain, seeds):
        T = self.n_domain
        task_in = x.expand(T, *x.shape)  # [T, B, D]
        shared_in = x
        for level in range(self.num_levels):
            p = {n: getattr(self, f"{n}_{level}") for n in (
                "task_expert_kernel", "task_expert_bias", "shared_expert_kernel",
                "shared_expert_bias", "task_gate_kernel", "shared_gate_kernel")}
            task_experts = torch.relu(
                torch.einsum("kbi,ktio->ktbo", task_in, p["task_expert_kernel"])
                + p["task_expert_bias"][:, :, None, :])  # [T, t, B, D']
            shared_experts = torch.relu(
                torch.einsum("bi,sio->sbo", shared_in, p["shared_expert_kernel"])
                + p["shared_expert_bias"][:, None, :])  # [s, B, D']
            gates = torch.softmax(
                torch.einsum("kbi,kie->kbe", task_in, p["task_gate_kernel"]), dim=-1)
            cat = torch.cat([task_experts, shared_experts.expand(T, *shared_experts.shape)],
                            dim=1)  # [T, t+s, B, D']
            task_in = torch.einsum("kbe,kebd->kbd", gates, cat)
            all_experts = torch.cat(
                [task_experts.reshape(-1, *task_experts.shape[2:]), shared_experts], dim=0)
            sgates = torch.softmax(shared_in @ p["shared_gate_kernel"], dim=-1)
            shared_in = torch.einsum("be,ebd->bd", sgates, all_experts)
        return select_head(self.towers(task_in, seeds), domain)
