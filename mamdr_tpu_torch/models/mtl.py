"""Multi-task CTR models: SharedBottom, MMoE and PLE, one task a domain.

Counterpart of ``mamdr_tpu/models/mtl.py`` (reference
model_zoo/DeepMTLCTR/deep_mtl_ctr.py:17-233). A batch is one domain's, and
its logit is the head of its domain's task, ``domain[0]``. SharedBottom and
MMoE compute ALL T task towers batched on a leading task axis ([T, ...]
einsums) and select that head (``select_head``). PLE with whole task leaves
runs its levels before the last for every task (their task outputs feed the
next level's shared gate), and its last CGC level and tower for the batch's
task alone: the task-indexed leaves of those are gathered at ``domain[:1]``
(``torch.index_select``, whose backward scatters into zeros, so every other
task's slice gets a gradient of exactly 0), the last level's shared mix,
which feeds nothing, is not computed, and the tower's dropout masks are the
task's rows of the whole [T, B, units] masks. In a lane forward
(``ZooModel.apply_lanes``) each lane takes its own ``domain[:, 0]``.

Parameter trees keep the flax names: ``towers/tower_{kernel,bias}_i``,
``towers/tower_logit``, ``experts/expert_{kernel,bias}_i``, ``gate_kernel``,
``gate_dnn/Dense_i/Dense_0/...``, ``bottom_dnn/...``, and PLE's
``{task,shared}_expert_{kernel,bias}_l``, ``task_gate_kernel_l`` and
``shared_gate_kernel_l``. Kernels of rank 3 and 4 are drawn with flax's
fans (``layers.fans``: the receptive field counts). Dropout sites, in flax's
call order: SharedBottom the bottom DNN's layers then the towers'; MMoE the
experts', the gate DNN's, then the towers'; PLE the towers' only.

Expert parallelism (``train.shard_experts`` on a mesh; JAX
parallel/trainer_sharding.py:49-59, where the SPMD partitioner inserts the
collective): a model whose expert-bank leaves hold fewer experts (MMoE) or
tasks (PLE's task experts) than the model has is a rank's slice of them,
at its table index on the ``expert_mesh`` it was built with. The rank runs
its experts only, the gate-mixed sum over experts is completed by one
``all_reduce`` over the table group (the mesh's ``table_sum``), and every
replicated tensor that feeds the rank's part (the input, the gates, PLE's
shared experts) passes the mesh's ``table_copy``, whose backward sums its
gradient over the table group, so every replicated leaf's gradient is
whole on every rank. With whole leaves both are the identity, and the same
code computes the whole model. An expert's dropout mask is its rows of the
whole bank's. Both collectives run under ``torch.func.vmap`` (the lanes).
A rank's slice of PLE runs every task's last level and tower, since the
batch's task may sit on another rank.

PLE's forward is traced (``utils/trace.py``): the spans ``ple.experts`` (the
task and shared expert products with their ReLU), ``ple.gates`` (both
gates' softmax and the mixes) and ``ple.towers`` (the task towers and the
head's selection), also under ``vmap``; the backward runs inside the train
step's ``step.loss_grad`` (on the card from autograd's device thread, where
no span is open). ``apply`` and ``apply_lanes`` count, from
the leaves' shapes and the ids', ``ple.expert_rows`` (rows times the experts
computed) and ``ple.expert_rows_used`` (rows times the experts the selected
head depends on: every expert of the levels before the last, and the
batch's task's own and the shared ones of the last). With whole task leaves
the two are equal; a rank's slice computes its tasks' and the shared
experts of every level.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from mamdr_tpu_torch.models.deepctr import ZooModel
from mamdr_tpu_torch.models.layers import DNN, FastDropout, glorot_normal, glorot_uniform
from mamdr_tpu_torch.ops.embedding_lookup import gather_fields
from mamdr_tpu_torch.ops.fast_random import IOTA_MUL, MASK32
from mamdr_tpu_torch.utils import trace


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


def _param(shape, init, generator) -> nn.Parameter:
    return nn.Parameter(init(torch.empty(shape), generator))


def _zeros(shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape))


_LEVEL_LEAVES = ("task_expert_kernel", "task_expert_bias", "shared_expert_kernel",
                 "shared_expert_bias", "task_gate_kernel", "shared_gate_kernel")
_TASK_LEAVES = ("task_expert_kernel", "task_expert_bias", "task_gate_kernel")  # [T, ...]


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

    def forward(self, x: torch.Tensor, seeds=None, first: int = 0) -> torch.Tensor:
        """The bank's experts as its leaves hold them: all E, or a rank's
        slice starting at expert ``first``, whose dropout masks are those
        experts' rows of the whole [E, B, D] mask."""
        x = x.expand(self.expert_kernel_0.shape[0], *x.shape)
        for li in range(self.n_layers):
            w, b = getattr(self, f"expert_kernel_{li}"), getattr(self, f"expert_bias_{li}")
            x = torch.relu(torch.einsum("ebi,eio->ebo", x, w) + b[:, None, :])
            seed = None if seeds is None else seeds[li]
            if seed is not None and first:  # a row offset of the flat mask index
                seed = (seed + (first * x.shape[1] * x.shape[2] * IOTA_MUL & MASK32)) & MASK32
            x = self.dropout(x, seed)
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
                 generator: Optional[torch.Generator] = None, expert_mesh=None):
        super().__init__(n_uid, n_pid, n_domain, user_dim, item_dim, domain_dim, hidden_dim,
                         dropout, pretrained_user, pretrained_item, generator)
        self.tower_hidden_dim = tuple(int(h) for h in tower_hidden_dim)
        self.num_experts = num_experts
        self.gate_dnn_hidden_units = tuple(int(h) for h in gate_dnn_hidden_units)
        self.specific_expert_num, self.shared_expert_num = specific_expert_num, shared_expert_num
        self.num_levels = num_levels
        self.expert_mesh = expert_mesh  # a rank's expert slices run on it (shard_experts)

    def _towers(self, in_features: int, generator):
        self.towers = TaskTowers(self.n_domain, in_features, self.tower_hidden_dim,
                                 self.dropout, generator)

    def _expert_split(self, held: int, total: int):
        """(first index, copy, sum) for leaves that hold ``held`` of
        ``total`` experts or tasks: a rank's slice with the expert mesh's
        ``table_copy`` and ``table_sum``, or (0, identity, identity) for
        whole leaves."""
        if held == total:
            return 0, _same, _same
        mesh = self.expert_mesh
        if mesh is None:
            raise ValueError(f"the expert leaves hold {held} of {total}: a slice needs the "
                             "model's expert_mesh")
        return mesh.table_index * held, mesh.table_copy, mesh.table_sum


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
        held = self.experts.expert_kernel_0.shape[0]
        first, copy, total = self._expert_split(held, self.num_experts)
        experts = self.experts(copy(x), _seeds(seeds, 0, ne), first)  # [E or its slice, B, D]
        gate_in = x
        if self.gate_dnn_hidden_units:
            gate_in = self.gate_dnn(gate_in, _seeds(seeds, ne, ne + ng))
        gates = torch.softmax(torch.einsum("bi,tie->tbe", gate_in, self.gate_kernel), dim=-1)
        mine = copy(gates)[..., first:first + held]
        mixed = total(torch.einsum("tbe,ebd->tbd", mine, experts))  # [T, B, D]
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

    def apply(self, params, uid, pid, domain, seeds=None, gather=gather_fields):
        self._count_rows(params, uid.numel())
        return super().apply(params, uid, pid, domain, seeds, gather)

    def apply_lanes(self, params, uid, pid, domain, gather=gather_fields, seeds=None):
        self._count_rows(params, uid.numel())
        return super().apply_lanes(params, uid, pid, domain, gather, seeds)

    def _count_rows(self, params, rows: int) -> None:
        """``ple.expert_rows`` and ``ple.expert_rows_used`` of a forward over
        ``rows`` rows, from the shapes of the expert leaves in ``params``
        (a lane axis, where they carry one, does not count): a level
        computes its held tasks' and its shared experts, except a last level
        over whole task leaves, which computes the batch's task's alone."""
        T, last, computed, used = self.n_domain, self.num_levels - 1, 0, 0
        for level in range(self.num_levels):
            held, t = params[f"task_expert_kernel_{level}"].shape[-4:-2]
            s = params[f"shared_expert_kernel_{level}"].shape[-3]
            computed += (t + s) if level == last and held == T else held * t + s
            used += (t + s) if level == last else T * t + s
        trace.count("ple.expert_rows", rows * computed)
        trace.count("ple.expert_rows_used", rows * used)

    def tower(self, x, lin, domain, seeds):
        T, last = self.n_domain, self.num_levels - 1
        held = self.task_expert_kernel_0.shape[0]
        first, copy, total = self._expert_split(held, T)
        task_in = x.expand(T, *x.shape)  # [T, B, D]
        shared_in = x
        for level in range(self.num_levels):
            p = {n: getattr(self, f"{n}_{level}") for n in _LEVEL_LEAVES}
            if level == last and held == T:  # whole task leaves: the batch's task alone
                d = domain[:1].long()
                ti = x[None] if level == 0 else torch.index_select(task_in, 0, d)
                return self._one_task(d, p, ti, shared_in, seeds)
            task_in, shared_in = self._level(first, held, copy, total, p, task_in, shared_in)
        with trace.span("ple.towers"):
            return select_head(self.towers(task_in, seeds), domain)

    def _one_task(self, d, p, task_in, shared_in, seeds):
        """The last level and the tower of task ``d`` ([1]) alone, on its
        input ``task_in`` [1, B, D]: the level's and the towers' task leaves
        gathered at ``d``, the level's shared mix left out (it feeds
        nothing), and each tower dropout seed advanced by ``d * B * units``
        steps of the mask's counter, so the masks are task ``d``'s rows of
        the whole [T, B, units] ones -> logits [B]."""
        # leaving out shared_gate_kernel is how ``_level`` is told this is a
        # last level: it then skips the shared mix
        p = {n: torch.index_select(v, 0, d) if n in _TASK_LEAVES else v
             for n, v in p.items() if n != "shared_gate_kernel"}
        out, _ = self._level(0, 1, _same, _same, p, task_in, shared_in)
        with trace.span("ple.towers"):
            leaves = {n: torch.index_select(v, 0, d) for n, v in self.towers.named_parameters()}
            if seeds is not None and self.tower_hidden_dim:
                # d * B * units * IOTA_MUL mod 2**32; d < T keeps d * c inside int64
                rows = out.shape[1]
                step = torch.cat([d * (rows * u * IOTA_MUL & MASK32)
                                  for u in self.tower_hidden_dim])
                seeds = (seeds + step) & MASK32
            return torch.func.functional_call(self.towers, leaves, (out, seeds)).squeeze(0)

    def _level(self, first: int, held: int, copy, total, p, task_in, shared_in):
        """One CGC level over tasks [first, first + held) of ``task_in``'s
        (all of them on one device): their experts, gates and mixed outputs,
        summed over the table group into the whole [task_in.shape[0], B, D']
        (a zero-filled placement); the shared path's mix is its part over
        those tasks' experts, summed over the group, plus the shared
        experts' part (replicated). A ``p`` without ``shared_gate_kernel``
        marks a last level, whose shared mix feeds nothing: the mix is then
        not computed, and None is returned in its place."""
        T, n_in = self.n_domain, task_in.shape[0]
        ti, gk = copy(task_in), copy(p["task_gate_kernel"])
        if held < n_in:  # a slice's backward is a zero fill and a copy: only where it cuts
            ti, gk = ti[first:first + held], gk[first:first + held]
        with trace.span("ple.experts"):
            task_experts = torch.relu(
                torch.einsum("kbi,ktio->ktbo", ti, p["task_expert_kernel"])
                + p["task_expert_bias"][:, :, None, :])  # [held, t, B, D']
            shared_experts = torch.relu(
                torch.einsum("bi,sio->sbo", shared_in, p["shared_expert_kernel"])
                + p["shared_expert_bias"][:, None, :])  # [s, B, D']
        with trace.span("ple.gates"):
            gates = torch.softmax(torch.einsum("kbi,kie->kbe", ti, gk), dim=-1)
            se = copy(shared_experts)
            # [held, t+s, B, D']
            cat = torch.cat([task_experts, se.expand(held, *se.shape)], dim=1)
            local = torch.einsum("kbe,kebd->kbd", gates, cat)  # [held, B, D']
            if held < n_in:
                rest = local.shape[1:]
                local = torch.cat([local.new_zeros((first, *rest)), local,
                                   local.new_zeros((n_in - first - held, *rest))])
            if "shared_gate_kernel" not in p:
                return total(local), None
            t = task_experts.shape[1]
            sgates = torch.softmax(shared_in @ p["shared_gate_kernel"], dim=-1)
            part = torch.einsum("be,ebd->bd", copy(sgates)[:, first * t:(first + held) * t],
                                task_experts.reshape(-1, *task_experts.shape[2:]))
            shared_out = total(part) + torch.einsum("be,ebd->bd", sgates[:, T * t:],
                                                    shared_experts)
            return total(local), shared_out
