"""The (data, table) process mesh and its collectives.

Counterpart of ``mamdr_tpu/parallel/mesh.py``. The JAX package is one
process over a ``jax.sharding.Mesh`` and XLA inserts the collectives; the
port is PyTorch's model instead: one process a device (``torchrun
--nproc-per-node N``, or a caller that starts the ranks itself), and the
collectives are explicit. A world of W = data x table ranks puts rank r at
(r // table, r % table):

  - its TABLE group holds the ranks of its data index: they see the same
    rows of a batch and each holds rows / table rows of every row-sharded
    table (parallel/embedding_shard.py);
  - its DATA group holds the ranks of its table index: replicated
    gradients and table-shard gradients are summed over it.

Every collective here is built from ``all_reduce`` and ``broadcast``, the
two that PyTorch's gloo backend takes for CUDA tensors as well as NCCL: an
all-gather is the ``all_reduce`` of a zero-filled buffer into which each
rank writes its slice, and x + 0 = x, so it is exact. The same code runs on
NCCL on the card, on gloo on the CPU (the tests), and on gloo with CUDA
tensors where several ranks share one card (NCCL refuses two ranks on one
device): there each helper stages the tensor through host memory itself —
one device-to-host copy, the collective on the host copy, one copy back —
as written in ``_on_backend``. NCCL with a CPU tensor raises.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional, Tuple

import torch
import torch.distributed as dist

from mamdr_tpu_torch import DeviceLike

DATA_AXIS = "data"
TABLE_AXIS = "table"


def mesh_shape(n: int, table_parallelism: Optional[int] = None) -> Tuple[int, int]:
    """(data, table) for n ranks, the JAX rule (mesh.py:31-42): the default
    table axis is the largest power of two dividing n, capped at 4 (gather
    traffic grows with the table axis, so most ranks go to data
    parallelism). Raises ``ValueError`` when the table axis does not divide
    n."""
    if table_parallelism is None:
        table_parallelism = 1
        while table_parallelism < 4 and n % (table_parallelism * 2) == 0:
            table_parallelism *= 2
    if table_parallelism < 1 or n % table_parallelism != 0:
        raise ValueError(f"{n} devices not divisible by table={table_parallelism}")
    return n // table_parallelism, table_parallelism


class Mesh:
    """One rank's view of the (data, table) mesh: its coordinates, its
    device, the backend and its two process groups (``make_mesh``)."""

    def __init__(self, data: int, table: int, rank: int, device: torch.device,
                 backend: str, groups):
        self.data, self.table, self.rank = data, table, rank
        self.device, self.backend = device, backend
        self._groups = groups  # {axis: process group of this rank}

    @property
    def shape(self):
        return {DATA_AXIS: self.data, TABLE_AXIS: self.table}

    @property
    def size(self) -> int:
        return self.data * self.table

    @property
    def data_index(self) -> int:
        return self.rank // self.table

    @property
    def table_index(self) -> int:
        return self.rank % self.table

    def index(self, axis: str) -> int:
        """This rank's position along ``axis``: its rank within that group."""
        return self.data_index if axis == DATA_AXIS else self.table_index

    def group(self, axis: str):
        return self._groups[axis]

    def group_size(self, axis: str) -> int:
        return self.shape[axis]

    def table_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``table_sum`` on this mesh (a model's expert split calls it)."""
        return table_sum(self, x)

    def table_copy(self, x: torch.Tensor) -> torch.Tensor:
        """``table_copy`` on this mesh."""
        return table_copy(self, x)

    def global_rank(self, axis: str, index: int) -> int:
        """The world rank at ``index`` along ``axis`` in this rank's group."""
        if axis == DATA_AXIS:
            return index * self.table + self.table_index
        return self.data_index * self.table + index

    def __repr__(self):
        return (f"Mesh(data={self.data}, table={self.table}, rank={self.rank}, "
                f"device={self.device}, backend={self.backend})")


def _device_of_rank(device: DeviceLike) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("the mesh runs on CUDA cards and none is available; pass "
                           "device='cpu' to run its ranks on the CPU explicitly")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def init_distributed(backend: Optional[str] = None, device: DeviceLike = None,
                     init_method: Optional[str] = None) -> torch.device:
    """Join the process group from ``RANK`` / ``WORLD_SIZE`` (as ``torchrun``
    sets them, with ``MASTER_ADDR`` / ``MASTER_PORT`` for the default
    ``env://``; or any ``init_method``, such as ``file://<path>``). Returns
    this rank's device: ``cuda:{LOCAL_RANK}`` unless ``device`` names one.
    The backend is nccl on the card and gloo on the CPU, or ``backend``
    (gloo for ranks that share one card). A missing card raises, and so does
    nccl for CPU ranks."""
    dev = _device_of_rank(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("nccl takes CUDA tensors only: use gloo for CPU ranks")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        for var in ("RANK", "WORLD_SIZE"):
            if var not in os.environ:
                raise RuntimeError(f"init_distributed needs {var} in the environment "
                                   "(torchrun sets it)")
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    return dev


def make_mesh(world_size: Optional[int] = None, table_parallelism: Optional[int] = None,
              device: DeviceLike = None) -> Mesh:
    """This rank's (data, table) ``Mesh`` over the initialised process group
    (``init_distributed``), factored by ``mesh_shape``. Every rank must call
    it, in the same order as its other group creations: it makes every
    table group and every data group. ``world_size`` defaults to the group's
    and must equal it. Raises without a process group."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call init_distributed first")
    world = dist.get_world_size()
    if world_size is not None and int(world_size) != world:
        raise ValueError(f"world_size {world_size} but the process group has {world} ranks")
    data, table = mesh_shape(world, table_parallelism)
    rank = dist.get_rank()
    groups = {}
    for i in range(data):
        g = dist.new_group([i * table + j for j in range(table)])
        if rank // table == i:
            groups[TABLE_AXIS] = g
    for j in range(table):
        g = dist.new_group([i * table + j for i in range(data)])
        if rank % table == j:
            groups[DATA_AXIS] = g
    return Mesh(data, table, rank, _device_of_rank(device), dist.get_backend(), groups)


def _on_backend(mesh: Mesh, t: torch.Tensor, op, inplace: bool = False) -> torch.Tensor:
    """Run the in-place collective ``op`` on ``t`` itself (``inplace``: a
    contiguous buffer the caller owns) or on a copy of it, and return the
    result. gloo with a CUDA tensor: the collective runs on a host copy,
    which is copied back (the host staging named in the module docstring);
    nccl with a CPU tensor raises."""
    if mesh.backend == "nccl" and t.device.type != "cuda":
        raise ValueError("nccl takes CUDA tensors only")
    if inplace and not t.is_contiguous():
        raise ValueError("an in-place collective needs a contiguous buffer")
    if mesh.backend == "gloo" and t.device.type == "cuda":
        host = t.detach().to("cpu", copy=True)
        op(host)
        return t.copy_(host) if inplace else host.to(t.device)
    out = t if inplace else t.detach().clone(memory_format=torch.contiguous_format)
    op(out)
    return out


def all_reduce_sum(mesh: Mesh, t: torch.Tensor, axis: str) -> torch.Tensor:
    """The sum of ``t`` over this rank's ``axis`` group, as a new tensor;
    every member gets the same bits."""
    return _on_backend(mesh, t, lambda x: dist.all_reduce(x, group=mesh.group(axis)))


def all_reduce_sum_(mesh: Mesh, t: torch.Tensor, axis: str) -> torch.Tensor:
    """``all_reduce_sum`` into ``t`` itself, a contiguous buffer the caller
    owns and no one else reads (a gathered x, a concatenated gradient
    vector, a zero-filled gather buffer); returns ``t``."""
    return _on_backend(mesh, t, lambda x: dist.all_reduce(x, group=mesh.group(axis)),
                       inplace=True)


class _TableSum(torch.autograd.Function):
    """The sum over the table group; its backward passes the gradient
    through (each member already holds the whole downstream gradient).
    Under ``torch.func.vmap`` the sum runs on the batched tensor."""

    @staticmethod
    def forward(x, mesh):
        return all_reduce_sum(mesh, x, TABLE_AXIS)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g, None

    @staticmethod
    def vmap(info, in_dims, x, mesh):
        return _TableSum.apply(x, mesh), in_dims[0]


class _TableCopy(torch.autograd.Function):
    """The identity, whose backward sums the gradient over the table group:
    a replicated tensor that feeds a computation each member does only a
    part of (its experts) gets a part of its gradient on each member."""

    @staticmethod
    def forward(x, mesh):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(ctx.mesh, g, TABLE_AXIS), None

    @staticmethod
    def vmap(info, in_dims, x, mesh):
        return _TableCopy.apply(x, mesh), in_dims[0]


def table_sum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the table group, differentiable (identity backward)."""
    return _TableSum.apply(x, mesh)


def table_copy(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """``x`` itself; its gradient is summed over the table group."""
    return _TableCopy.apply(x, mesh)


def all_gather_dim0(mesh: Mesh, t: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
    """The members' ``t`` of this rank's ``axis`` group concatenated along
    ``dim`` in group order, exactly: the ``all_reduce`` of zeros holding
    this rank's slice (x + 0 = x)."""
    n, i = mesh.group_size(axis), mesh.index(axis)
    shape = list(t.shape)
    size = shape[dim]
    shape[dim] = n * size
    buf = torch.zeros(shape, dtype=t.dtype, device=t.device)
    buf.narrow(dim, i * size, size).copy_(t)
    return all_reduce_sum_(mesh, buf, axis)


def broadcast(mesh: Mesh, t: torch.Tensor, axis: str, src_index: int) -> torch.Tensor:
    """``t`` of the member at ``src_index`` of this rank's ``axis`` group,
    as a new tensor on every member."""
    src = mesh.global_rank(axis, src_index)
    return _on_backend(mesh, t, lambda x: dist.broadcast(x, src=src, group=mesh.group(axis)))


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """A picklable host object of world rank ``src`` on every rank."""
    box: List[Any] = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def barrier() -> None:
    dist.barrier()


def shutdown() -> None:
    """Wait for every rank, then leave the process group: a rank that exits
    while another still talks to it aborts the other's transport."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
