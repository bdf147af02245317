"""Fused MLP train step: forward + weighted BCE + backward of the whole tower.

Counterpart of ``mamdr_tpu/ops/fused_mlp_step.py``. ``fused_tower_grad``
computes what the Pallas kernel ``_fused_tower_grad`` (``:141``, body
``_make_kernel`` ``:63-135``) computes: for tower dims [in, h1, ..., hk]
and a bias-free 1-logit head, Dense -> ReLU -> inverted hash dropout per
layer, the loss sum(w*bce)/max(sum(w), 1), and the backward pass through
every layer with the dropout masks recomputed, returning the loss, dx and
every weight gradient. On a CUDA tensor it launches kernel K1
(``csrc/fused_mlp_step.cu``: a row-slab kernel and a weight-gradient kernel,
their products on the tensor cores as error-compensated TF32; ``tf32_split``
and ``k1_launch_plan`` are its rounding and its launch plan in plain
Python); on a CPU tensor it runs
``tower_grad_reference``, which repeats ``_make_kernel``'s arithmetic step
by step in plain PyTorch.

``make_fast_loss_grad`` is the counterpart of ``maybe_make_fast_loss_grad``
(``:217-314``): the three lookups and their concat as one launch of the
field gather (kernel K2, ``ops/embedding_lookup.py::gather_fields``), the
tower kernel, and the gradient tree — dense grads from the kernel, the
domain-table scatter-add of dx plus its l2 term, and user/item table grads
only when the tables train. A frozen table gets no gradient at all
(``None``), so no table-sized tensor is made per step for it.

``fused_tower_grad_lanes`` is the same step over a leading lane axis: L
independent towers (the query-domain lanes of the Domain-Regularization
phase) advance in one call of K1, and ``make_fast_loss_grad``'s function
serves both shapes. The JAX package runs its lanes through autodiff under
``vmap`` (``train/steps.py:187-190``); the port's lanes go through the
kernel.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from mamdr_tpu_torch.models.embeddings import FIELD_TABLES, frozen_mask
from mamdr_tpu_torch.ops import _cuda
from mamdr_tpu_torch.ops.embedding_lookup import gather_fields, scatter_rows
from mamdr_tpu_torch.ops.fast_random import MASK32, dropout_mask
from mamdr_tpu_torch.utils import trace, trees

def _dropout_scale(rate: float) -> float:
    """1/(1-rate) rounded to float32, as the Pallas kernel's constant."""
    return float(np.float32(1.0 / (1.0 - rate)))


def tower_forward_reference(x, seeds, dense, dims, rate):
    """Forward pass of the plain version: (zs, acts, keeps, logits) with the
    per-layer pre-activations z [B, h], the layer inputs acts (x first), the
    dropout keep masks (empty when rate is 0) and the logits [B, 1]."""
    n_layers = len(dims) - 1
    ws = dense[0 : 2 * n_layers : 2]
    bs = dense[1 : 2 * n_layers : 2]
    scale = _dropout_scale(rate) if rate > 0.0 else 1.0
    acts, zs, keeps = [x], [], []
    h = x
    for i in range(n_layers):
        z = h @ ws[i] + bs[i]
        zs.append(z)
        a = torch.clamp(z, min=0.0)
        if rate > 0.0:
            keep = dropout_mask(seeds[i], rate, z.shape, device=z.device)
            keeps.append(keep)
            h = torch.where(keep, a * scale, 0.0)
        else:
            h = a
        acts.append(h)
    return zs, acts, keeps, h @ dense[2 * n_layers]


def tower_grad_reference(x, label, weight, seeds, dense, dims, rate):
    """Plain PyTorch version of the fused tower step (any device).

    x [B, in]; label, weight [B]; seeds [L] uint32 values (int64 tensor);
    dense = (W1, b1, ..., Wk, bk, Wl) with W [in, out], b [out], Wl [hk, 1].
    Returns (loss [], dx [B, in], grads in dense's layout).
    """
    n_layers = len(dims) - 1
    ws = dense[0 : 2 * n_layers : 2]
    wl = dense[2 * n_layers]
    label = label.reshape(-1, 1)
    weight = weight.reshape(-1, 1)
    scale = _dropout_scale(rate) if rate > 0.0 else 1.0
    zs, acts, keeps, logits = tower_forward_reference(x, seeds, dense, dims, rate)

    e = torch.exp(-torch.abs(logits))
    bce = torch.clamp(logits, min=0.0) - logits * label + torch.log1p(e)
    denom = torch.clamp(torch.sum(weight), min=1.0)
    loss = torch.sum(bce * weight) / denom

    # sigmoid(z) - y without rounding sigmoid(z) near 1 before y = 1 cancels
    # it: with r = sigmoid(-|z|), (1 - y) - r for z >= 0 and r - y below
    r = torch.sigmoid(-torch.abs(logits))
    dlogits = torch.where(logits >= 0.0, (1.0 - label) - r, r - label) * weight / denom
    dwl = acts[-1].T @ dlogits
    dh = dlogits @ wl.T
    grads = [None] * (2 * n_layers)
    for i in range(n_layers - 1, -1, -1):
        da = torch.where(keeps[i], dh * scale, 0.0) if rate > 0.0 else dh
        dz = torch.where(zs[i] > 0.0, da, 0.0)
        grads[2 * i] = acts[i].T @ dz
        grads[2 * i + 1] = torch.sum(dz, dim=0)
        dh = dz @ ws[i].T
    return loss, dh, (*grads, dwl)


def tower_grad_reference_lanes(x, label, weight, seeds, dense, dims, rate):
    """Plain PyTorch version of the lane-batched step: every operand carries
    a leading lane axis (x [L, B, in], label and weight [L, B], seeds
    [L, n_layers], W [L, in, out], b [L, out], Wl [L, hk, 1]) and lane l is
    ``tower_grad_reference`` on lane l's operands, bit for bit.
    Returns (loss [L], dx [L, B, in], grads with a leading L)."""
    per_lane = [
        tower_grad_reference(x[l], label[l], weight[l], seeds[l],
                             tuple(t[l] for t in dense), dims, rate)
        for l in range(x.shape[0])
    ]
    loss = torch.stack([r[0] for r in per_lane])
    dx = torch.stack([r[1] for r in per_lane])
    grads = tuple(torch.stack([r[2][i] for r in per_lane]) for i in range(len(dense)))
    return loss, dx, grads


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of a float32 tensor as kernel K1 splits its operands
    (``tf32_split`` in ``csrc/fused_mlp_step.cu``): hi is x rounded to TF32's
    11 significant bits by Veltkamp's splitting, c = 8193 x, hi = c - (c - x),
    and lo is x - hi cut to the 19 bits a tensor core reads of a TF32
    operand. x = hi + lo up to about 2^-21 |x|, and lo1*hi2 + hi1*lo2 +
    hi1*hi2 is the product K1 accumulates in float32 ("3xTF32")."""
    c = x * 8193.0
    hi = c - (c - x)
    lo = ((x - hi).contiguous().view(torch.int32) & -0x2000).view(torch.float32)
    return hi, lo


SHARED_BYTES_MAX = 232448  # 227 KB: the most shared memory a block may opt into
MAX_LAYERS = 8             # of a tower K1 takes
# csrc/fused_mlp_step.cu's tiling: the streamed operand's stages, the rows of
# a loss partial, the weight-gradient tile, columns of a column-sum block
_W_TILE_FLOATS, _X_ROW_FLOATS, _STAGES, _LOSS_ROWS, _DW_TILE, _SUM_COLS = 128 * 36, 36, 3, 16, 64, 8


class K1Plan(NamedTuple):
    """How kernel K1 runs one call (see ``k1_launch_plan``)."""
    slab_rows: int         # rows of a lane one block of the first launch keeps on chip
    slabs: int             # of a lane: the first launch's grid is (slabs, lanes)
    shared_bytes: int      # of a block of the first launch
    dw_blocks: int         # of a lane: the second launch's grid is (dw_blocks, lanes)
    workspace_floats: int  # h, dz, dlogits and loss partials of all lanes
    launches: int          # CUDA launches a call issues


def _up4(v: int) -> int:
    return (v + 3) // 4 * 4


def k1_launch_plan(dims: Sequence[int], batch: int, lanes: int,
                   sm_count: int = 132) -> K1Plan:
    """Kernel K1's two launches for a tower of ``dims`` on ``lanes`` lanes of
    ``batch`` rows, as ``csrc/fused_mlp_step.cu`` lays them out: the slab, its
    shared memory, the second launch's blocks and the workspace. A slab is
    64, 32 or 16 rows: the largest whose hidden activations and stages fit a
    block's 227 KB of shared memory and whose blocks still cover the card's
    ``sm_count`` SMs (30 lanes of 1024 rows: 480 blocks of 64 rows), else 16
    (one lane of 1024 rows: 64 blocks on 132 SMs). The slab changes no
    result: every row is computed alike and the loss is summed per 16 rows
    either way. Raises ``ValueError`` for a tower too wide for any slab
    (there is no other route for a CUDA tensor)."""
    dims = tuple(int(d) for d in dims)
    n_layers = len(dims) - 1
    if not 1 <= n_layers <= MAX_LAYERS or min(dims) < 1 or batch < 1 or lanes < 1:
        raise ValueError(f"K1 takes 1..{MAX_LAYERS} layers of positive width and batch, "
                         f"lanes >= 1; got dims {dims}, batch {batch}, lanes {lanes}")
    # a row of every hidden activation, padded to whole 32-deep k-tiles plus 4
    # floats (against bank conflicts); a stage is a weight tile and a k-tile
    # of the slab's x
    row_floats = sum((d + 31) // 32 * 32 + 4 for d in dims[1:])
    for slab_rows in (64, 32, 16):
        shared = 4 * (slab_rows * row_floats
                      + _STAGES * (_W_TILE_FLOATS + slab_rows * _X_ROW_FLOATS)
                      + 2 * slab_rows + 12)
        if shared <= SHARED_BYTES_MAX and (
                slab_rows == 16 or lanes * -(-batch // slab_rows) >= sm_count):
            break
    else:
        raise ValueError(f"a tower of dims {dims} is too wide for K1: 16 rows of its "
                         f"activations need {shared} bytes of shared memory, more than a "
                         f"block's {SHARED_BYTES_MAX}")
    tiles = lambda n: -(-n // _DW_TILE)
    dw_blocks = -(-dims[-1] // _SUM_COLS) + sum(
        tiles(dims[i]) * tiles(dims[i + 1]) + -(-dims[i + 1] // _SUM_COLS)
        for i in range(n_layers))
    per_lane = (2 * sum(_up4(batch * d) for d in dims[1:]) + _up4(batch)
                + _up4(-(-batch // _LOSS_ROWS) + 1))
    return K1Plan(slab_rows, -(-batch // slab_rows), shared, dw_blocks, lanes * per_lane, 2)


@functools.lru_cache(maxsize=None)
def _bind():
    """(kernel entry, workspace-size query, shared-memory query, launch
    counter) of the built library, bound once."""
    lib = _cuda.load("fused_mlp_step")
    fn = lib.mamdr_fused_tower_grad
    vp, ip = ctypes.c_void_p, ctypes.c_int
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    dims_p = ctypes.POINTER(ctypes.c_int)
    fn.argtypes = [
        ip, ip, dims_p, ip, ip,          # lanes, n_layers, dims, batch, slab rows
        vp, vp, vp, vp,                  # x, label, weight, seeds
        ptrs, ptrs, vp,                  # W[], b[], Wl
        ctypes.c_float, ctypes.c_float,  # rate, scale
        vp, vp, ptrs, ptrs, vp,          # loss, dx, dW[], db[], dWl
        ptrs, vp, ctypes.c_longlong, vp,  # z[] or null, workspace, its floats, stream
    ]
    fn.restype = ctypes.c_int
    scratch = lib.mamdr_fused_tower_scratch
    scratch.argtypes = [ip, dims_p, ip]
    scratch.restype = ctypes.c_longlong
    shared = lib.mamdr_fused_tower_shared
    shared.argtypes = [ip, dims_p, ip]
    shared.restype = ctypes.c_longlong
    count = lib.mamdr_fused_tower_launch_count
    count.argtypes = []
    count.restype = ctypes.c_int
    return fn, scratch, shared, count


def k1_cuda_launches(build: bool = True) -> Optional[int]:
    """CUDA launches kernel K1's library has issued so far in this process (a
    call of either wrapper adds ``k1_launch_plan(...).launches``). With
    ``build=False`` None until the library is loaded: the read never builds
    it."""
    if not build and not _bind.cache_info().currsize:
        return None
    return _bind()[3]()


def _ptr_array(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _seeds_as_int32(seeds: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> the same 32 bits as int32 (on device)."""
    s = seeds.to(torch.int64) & MASK32
    return (s - ((s & 0x80000000) << 1)).to(torch.int32).contiguous()


def _launch_k1(x, label, weight, seeds, dense, dims, rate, want_z=False):
    """Check lane-stacked CUDA operands ([L, ...] each), allocate the outputs
    and launch kernel K1 once for all L lanes. The workspace (what the first
    launch leaves for the second: h, dz, dlogits, loss partials) comes from
    ``_workspace``: one tensor per (device, L, B, dims), used again by every
    later call of that shape, so calls of one shape belong on one stream.
    Returns (loss, dx, grads, zs); zs are the per-layer pre-activations
    [L, B, h] when ``want_z`` (a check's request), else None.
    """
    dims = tuple(int(d) for d in dims)
    n_layers = len(dims) - 1
    if n_layers < 1 or len(dense) != 2 * n_layers + 1:
        raise ValueError("dense must be (W1, b1, ..., Wk, bk, Wl)")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} outside [0, 1)")
    _cuda.require_cuda(x, "x", torch.float32)
    _cuda.require_cuda(label, "label", torch.float32)
    _cuda.require_cuda(weight, "weight", torch.float32)
    if x.dim() != 3 or x.shape[2] != dims[0] or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"x must be [L>=1, B>=1, {dims[0]}], got {tuple(x.shape)}")
    lanes, b = int(x.shape[0]), int(x.shape[1])
    if tuple(label.shape) != (lanes, b) or tuple(weight.shape) != (lanes, b):
        raise ValueError("label and weight must hold one value per lane and row")
    if tuple(seeds.shape) != (lanes, n_layers) or seeds.device != x.device:
        raise ValueError(f"seeds must be [{lanes}, {n_layers}] on {x.device}")
    for i in range(n_layers):
        w, bias = dense[2 * i], dense[2 * i + 1]
        _cuda.require_cuda(w, f"W{i + 1}", torch.float32)
        _cuda.require_cuda(bias, f"b{i + 1}", torch.float32)
        if (tuple(w.shape) != (lanes, dims[i], dims[i + 1])
                or tuple(bias.shape) != (lanes, dims[i + 1])):
            raise ValueError(f"layer {i + 1}: W {tuple(w.shape)}, b {tuple(bias.shape)} "
                             f"do not fit {lanes} lanes of dims {dims}")
    wl = dense[2 * n_layers]
    _cuda.require_cuda(wl, "Wl", torch.float32)
    if wl.shape[0] != lanes or wl.numel() != lanes * dims[-1]:
        raise ValueError(f"Wl must hold {lanes} x {dims[-1]} values, got {tuple(wl.shape)}")
    plan = k1_launch_plan(dims, b, lanes, _cuda.sm_count(x.device))  # raises: tower too wide

    f32 = dict(dtype=torch.float32, device=x.device)
    loss = torch.empty((lanes,), **f32)
    dx = torch.empty((lanes, b, dims[0]), **f32)
    dws = [torch.empty((lanes, dims[i], dims[i + 1]), **f32) for i in range(n_layers)]
    dbs = [torch.empty((lanes, dims[i + 1]), **f32) for i in range(n_layers)]
    dwl = torch.empty(tuple(wl.shape), **f32)
    zs = ([torch.empty((lanes, b, dims[i + 1]), **f32) for i in range(n_layers)]
          if want_z else None)
    workspace = _workspace(x.device, lanes, b, dims)
    seeds32 = _seeds_as_int32(seeds)
    scale = _dropout_scale(rate) if rate > 0.0 else 1.0

    rc = _bind()[0](
        lanes, n_layers, (ctypes.c_int * len(dims))(*dims), b, plan.slab_rows,
        x.data_ptr(), label.data_ptr(), weight.data_ptr(), seeds32.data_ptr(),
        _ptr_array(dense[0 : 2 * n_layers : 2]), _ptr_array(dense[1 : 2 * n_layers : 2]),
        wl.data_ptr(),
        rate, scale,
        loss.data_ptr(), dx.data_ptr(), _ptr_array(dws), _ptr_array(dbs), dwl.data_ptr(),
        _ptr_array(zs) if want_z else None, workspace.data_ptr(), workspace.numel(),
        _cuda.stream_ptr(x.device),
    )
    _cuda.check(rc, "fused_tower_grad")
    grads = [g for i in range(n_layers) for g in (dws[i], dbs[i])]
    return loss, dx, (*grads, dwl), zs


WORKSPACES_KEPT = 4  # shapes whose workspace stays allocated (a DN step's, a lane-step's, ...)


def _workspace(device, lanes: int, batch: int, dims: Tuple[int, ...]) -> torch.Tensor:
    """Kernel K1's workspace for this shape, sized by the built library's own
    layout (``mamdr_fused_tower_scratch``; the C entry is told the length and
    refuses a shorter one). The ``WORKSPACES_KEPT`` shapes used last keep
    theirs; an older one is released. A shape's first call must not fall
    inside a CUDA-graph capture, whose private pool would then own a tensor
    that later eager calls use: warm up before capturing, as
    ``utils.timing.device_ms`` does."""
    key = (device, lanes, batch, dims)
    kept = _workspace.kept
    workspace = kept.get(key)
    if workspace is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"K1's first call for {lanes} lanes of {batch} rows, dims {dims}, falls inside "
                f"a CUDA-graph capture: call it once before capturing")
        per_lane = _bind()[1](len(dims) - 1, (ctypes.c_int * len(dims))(*dims), batch)
        if per_lane < 0:
            raise ValueError(f"K1 does not take dims {dims} at batch {batch}")
        workspace = kept[key] = torch.empty((lanes * per_lane,), dtype=torch.float32,
                                            device=device)
        while len(kept) > WORKSPACES_KEPT:
            kept.popitem(last=False)
    kept.move_to_end(key)
    return workspace


_workspace.kept = collections.OrderedDict()


def fused_tower_grad(x, label, weight, seeds, dense, dims, rate):
    """Fused tower step; see tower_grad_reference for the contract.

    CUDA tensors launch kernel K1 as its one-lane case (counted once per
    call in ``fused_tower_grad.launches``; a call is two CUDA launches, see
    ``k1_launch_plan``); CPU tensors run the plain version. Either is the
    span ``k1.tower``.
    """
    with trace.span("k1.tower"):
        if x.device.type == "cpu":
            return tower_grad_reference(x, label, weight, seeds, dense, dims, rate)
        if x.dim() != 2:
            raise ValueError(f"x must be [B, {dims[0]}], got {tuple(x.shape)}")
        if label.numel() != x.shape[0] or weight.numel() != x.shape[0]:
            raise ValueError("label and weight must hold one value per row")
        n_layers = len(dims) - 1
        if len(dense) != 2 * n_layers + 1 or any(
                t.dim() != (2 if i % 2 == 0 else 1) for i, t in enumerate(dense)):
            raise ValueError("dense must be (W1 [in,out], b1 [out], ..., Wl [hk,1])")
        loss, dx, grads, _ = _launch_k1(
            x[None], label.reshape(1, -1), weight.reshape(1, -1), seeds.reshape(1, -1),
            tuple(t[None] for t in dense), dims, rate)
        fused_tower_grad.launches += 1
        return loss[0], dx[0], tuple(g[0] for g in grads)


fused_tower_grad.launches = 0


def fused_tower_grad_lanes(x, label, weight, seeds, dense, dims, rate):
    """Fused tower step of L independent lanes in one call; see
    tower_grad_reference_lanes for the contract.

    CUDA tensors launch kernel K1 with the lane as a grid dimension of both
    of its launches (counted once per call in
    ``fused_tower_grad_lanes.launches``); lane l's results are bit-equal to
    ``fused_tower_grad`` on lane l's operands. CPU tensors run the plain
    version. Either is the span ``k1.tower``.
    """
    with trace.span("k1.tower"):
        if x.device.type == "cpu":
            return tower_grad_reference_lanes(x, label, weight, seeds, dense, dims, rate)
        loss, dx, grads, _ = _launch_k1(x, label, weight, seeds, dense, dims, rate)
        fused_tower_grad_lanes.launches += 1
        return loss, dx, grads


fused_tower_grad_lanes.launches = 0


def _counters() -> Dict[str, int]:
    out = {"k1.launches": fused_tower_grad.launches,
           "k1_lanes.launches": fused_tower_grad_lanes.launches}
    cuda = k1_cuda_launches(build=False)
    if cuda is not None:
        out["k1.cuda_launches"] = cuda
    return out


trace.register(_counters)


def dense_paths(model_params) -> Sequence[Tuple[str, ...]]:
    """MLP param tree -> ordered paths (W1, b1, ..., Wk, bk, Wl) of the tower."""
    names = sorted(model_params["dnn"].keys(), key=lambda s: int(s.split("_")[1]))
    paths = []
    for n in names:
        paths.append(("dnn", n, "Dense_0", "kernel"))
        paths.append(("dnn", n, "Dense_0", "bias"))
    paths.append(("logit", "Dense_0", "Dense_0", "kernel"))
    return paths


def make_fast_loss_grad(model, cfg, tower_grad: Optional[Callable] = None,
                        gather: Optional[Callable] = None):
    """Returns f(params, batch, seeds, train=True) -> (data_loss, grads), for
    one tower or for L lanes at once; the shapes of the batch decide.

    One tower: batch columns [B], ``seeds`` [n_layers], ``data_loss`` [].
    L lanes: batch columns [L, B], ``seeds`` [L, n_layers], ``data_loss``
    [L]; every trainable leaf of ``params`` carries a leading lane axis and a
    frozen user/item table is the one [N, D] tensor every lane reads (see
    ``gather_fields``). ``grads`` has the structure of ``params`` with
    ``None`` at frozen tables. The tower input x and the row ids of the
    tables that train come from ONE ``gather`` (kernel K2's wrapper by
    default; on a mesh, ``cfg.lookup``). ``tower_grad`` defaults to kernel
    K1's wrapper for the batch's shape; a check on the card passes the plain
    versions of both to compare a whole step.
    """
    dims = (
        int(model.user_dim) + int(model.item_dim) + int(model.domain_dim),
        *[int(h) for h in model.hidden_dim],
    )
    rate = float(model.dropout)
    u_dim, i_dim = int(model.user_dim), int(model.item_dim)
    l2 = float(cfg.l2_emb)
    frozen = frozen_mask(model.param_tree(), cfg.emb_trainable)["embedding"]
    train_mask = tuple(not frozen[k] for k in FIELD_TABLES)  # K2's (user, item, domain)
    gather = gather or cfg.lookup or gather_fields

    def table_grad(table, flat, dx_part):
        """``scatter_rows`` of dx's rows into the table, plus its l2 term."""
        if table.dim() != dx_part.dim():
            raise ValueError("a table that trains needs one copy per lane")
        g = scatter_rows(table.shape, flat, dx_part)
        return g + 2.0 * l2 * table if l2 else g

    def loss_grad(params, batch, seeds, train: bool = True):
        mp = params["model"]
        emb = mp["embedding"]
        x, (u_flat, p_flat, d_flat) = gather(
            (emb["user_emb"], emb["item_emb"], emb["domain_emb"]),
            (batch["uid"], batch["pid"], batch["domain"]),
            train_mask=train_mask)

        paths = dense_paths(mp)
        dense = tuple(trees.at(mp, path) for path in paths)
        tower = tower_grad or (fused_tower_grad_lanes if x.dim() == 3 else fused_tower_grad)
        data_loss, dx, dgrads = tower(
            x, batch["label"], batch["weight"], seeds, dense, dims,
            rate if train else 0.0,
        )

        grads_model = trees.tree_map(lambda leaf: None, mp)
        for path, g in zip(paths, dgrads):
            trees.at(grads_model, path[:-1])[path[-1]] = g.reshape(trees.at(mp, path).shape)

        # embedding grads: scatter-add of dx slices + l2 terms (frozen
        # tables get none: the optimizer never reads them)
        ge = grads_model["embedding"]
        ge["domain_emb"] = table_grad(emb["domain_emb"], d_flat, dx[..., u_dim + i_dim :])
        if train_mask[0]:
            ge["user_emb"] = table_grad(emb["user_emb"], u_flat, dx[..., :u_dim])
        if train_mask[1]:
            ge["item_emb"] = table_grad(emb["item_emb"], p_flat,
                                        dx[..., u_dim : u_dim + i_dim])
        return data_loss, {"model": grads_model}

    return loss_grad
