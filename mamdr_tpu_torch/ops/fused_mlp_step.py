"""Fused MLP train step: forward + weighted BCE + backward of the whole tower.

Counterpart of ``mamdr_tpu/ops/fused_mlp_step.py``. ``fused_tower_grad``
computes what the Pallas kernel ``_fused_tower_grad`` (``:141``, body
``_make_kernel`` ``:63-135``) computes: for tower dims [in, h1, ..., hk]
and a bias-free 1-logit head, Dense -> ReLU -> inverted hash dropout per
layer, the loss sum(w*bce)/max(sum(w), 1), and the backward pass through
every layer with the dropout masks recomputed, returning the loss, dx and
every weight gradient. On a CUDA tensor it launches kernel K1
(``csrc/fused_mlp_step.cu``); on a CPU tensor it runs
``tower_grad_reference``, which repeats ``_make_kernel``'s arithmetic step
by step in plain PyTorch.

``make_fast_loss_grad`` is the counterpart of ``maybe_make_fast_loss_grad``
(``:217-314``): the three lookups, the concat, the kernel, and the gradient
tree — dense grads from the kernel, the domain-table scatter-add of dx plus
its l2 term, and user/item table grads only when the tables train. A frozen
table gets no gradient at all (``None``), so no table-sized tensor is made
per step for it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from mamdr_tpu_torch.ops import _cuda
from mamdr_tpu_torch.ops.embedding_lookup import embedding_lookup
from mamdr_tpu_torch.ops.fast_random import MASK32, dropout_mask
from mamdr_tpu_torch.utils import trees

def _dropout_scale(rate: float) -> float:
    """1/(1-rate) rounded to float32, as the Pallas kernel's constant."""
    return float(np.float32(1.0 / (1.0 - rate)))


def tower_grad_reference(x, label, weight, seeds, dense, dims, rate):
    """Plain PyTorch version of the fused tower step (any device).

    x [B, in]; label, weight [B]; seeds [L] uint32 values (int64 tensor);
    dense = (W1, b1, ..., Wk, bk, Wl) with W [in, out], b [out], Wl [hk, 1].
    Returns (loss [], dx [B, in], grads in dense's layout).
    """
    n_layers = len(dims) - 1
    ws = dense[0 : 2 * n_layers : 2]
    bs = dense[1 : 2 * n_layers : 2]
    wl = dense[2 * n_layers]
    label = label.reshape(-1, 1)
    weight = weight.reshape(-1, 1)
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
    logits = h @ wl

    bce = (
        torch.clamp(logits, min=0.0)
        - logits * label
        + torch.log1p(torch.exp(-torch.abs(logits)))
    )
    denom = torch.clamp(torch.sum(weight), min=1.0)
    loss = torch.sum(bce * weight) / denom

    dlogits = (torch.sigmoid(logits) - label) * weight / denom  # [B,1]
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


@functools.lru_cache(maxsize=None)
def _bind():
    """(kernel entry, scratch-size query) of the built library, bound once."""
    lib = _cuda.load("fused_mlp_step")
    fn = lib.mamdr_fused_tower_grad
    vp, ip = ctypes.c_void_p, ctypes.c_int
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    fn.argtypes = [
        ip, ctypes.POINTER(ctypes.c_int), ip,     # n_layers, dims, batch
        vp, vp, vp, vp,                           # x, label, weight, seeds
        ptrs, ptrs, vp,                           # W[], b[], Wl
        ctypes.c_float, ctypes.c_float,           # rate, scale
        vp, vp, ptrs, ptrs, vp,                   # loss, dx, dW[], db[], dWl
        ptrs, ptrs, ptrs, vp,                     # z[], h[], dz[], dlogits
        vp, vp,                                   # split-K scratch, stream
    ]
    fn.restype = ctypes.c_int
    scratch = lib.mamdr_fused_tower_scratch
    scratch.argtypes = [ip, ctypes.POINTER(ctypes.c_int), ip]
    scratch.restype = ctypes.c_longlong
    return fn, scratch


def _ptr_array(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _seeds_as_int32(seeds: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> the same 32 bits as int32 (on device)."""
    s = seeds.to(torch.int64) & MASK32
    return (s - ((s & 0x80000000) << 1)).to(torch.int32).contiguous()


def fused_tower_grad(x, label, weight, seeds, dense, dims, rate):
    """Fused tower step; see tower_grad_reference for the contract.

    CUDA tensors launch kernel K1 (counted once per call in
    ``fused_tower_grad.launches``, however many CUDA launches it takes);
    CPU tensors run the plain version.
    """
    if x.device.type == "cpu":
        return tower_grad_reference(x, label, weight, seeds, dense, dims, rate)
    dims = tuple(int(d) for d in dims)
    n_layers = len(dims) - 1
    if n_layers < 1 or len(dense) != 2 * n_layers + 1:
        raise ValueError("dense must be (W1, b1, ..., Wk, bk, Wl)")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} outside [0, 1)")
    _cuda.require_cuda(x, "x", torch.float32)
    _cuda.require_cuda(label, "label", torch.float32)
    _cuda.require_cuda(weight, "weight", torch.float32)
    b = x.shape[0]
    if x.dim() != 2 or x.shape[1] != dims[0] or b < 1:
        raise ValueError(f"x must be [B>=1, {dims[0]}], got {tuple(x.shape)}")
    if label.numel() != b or weight.numel() != b:
        raise ValueError("label and weight must hold one value per row")
    if seeds.numel() != n_layers or seeds.device != x.device:
        raise ValueError(f"seeds must be {n_layers} values on {x.device}")
    for i in range(n_layers):
        w, bias = dense[2 * i], dense[2 * i + 1]
        _cuda.require_cuda(w, f"W{i + 1}", torch.float32)
        _cuda.require_cuda(bias, f"b{i + 1}", torch.float32)
        if tuple(w.shape) != (dims[i], dims[i + 1]) or bias.numel() != dims[i + 1]:
            raise ValueError(f"layer {i + 1}: W {tuple(w.shape)}, b {tuple(bias.shape)} "
                             f"do not fit dims {dims}")
    wl = dense[2 * n_layers]
    _cuda.require_cuda(wl, "Wl", torch.float32)
    if wl.numel() != dims[-1]:
        raise ValueError(f"Wl must hold {dims[-1]} values, got {tuple(wl.shape)}")

    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    loss = torch.empty((), **f32)
    dx = torch.empty((b, dims[0]), **f32)
    dws = [torch.empty((dims[i], dims[i + 1]), **f32) for i in range(n_layers)]
    dbs = [torch.empty((dims[i + 1],), **f32) for i in range(n_layers)]
    dwl = torch.empty(tuple(wl.shape), **f32)
    zs = [torch.empty((b, dims[i + 1]), **f32) for i in range(n_layers)]
    hs = [torch.empty((b, dims[i + 1]), **f32) for i in range(n_layers)]
    dzs = [torch.empty((b, dims[i + 1]), **f32) for i in range(n_layers)]
    dlog = torch.empty((b,), **f32)
    seeds32 = _seeds_as_int32(seeds)
    scale = _dropout_scale(rate) if rate > 0.0 else 1.0

    fn, scratch_floats = _bind()
    dims_c = (ctypes.c_int * len(dims))(*dims)
    split = torch.empty((scratch_floats(n_layers, dims_c, b),), **f32)
    rc = fn(
        n_layers, dims_c, b,
        x.data_ptr(), label.data_ptr(), weight.data_ptr(), seeds32.data_ptr(),
        _ptr_array(dense[0 : 2 * n_layers : 2]), _ptr_array(dense[1 : 2 * n_layers : 2]),
        wl.data_ptr(),
        rate, scale,
        loss.data_ptr(), dx.data_ptr(), _ptr_array(dws), _ptr_array(dbs), dwl.data_ptr(),
        _ptr_array(zs), _ptr_array(hs), _ptr_array(dzs), dlog.data_ptr(),
        split.data_ptr(), _cuda.stream_ptr(dev),
    )
    _cuda.check(rc, "fused_tower_grad")
    fused_tower_grad.launches += 1
    grads = [g for i in range(n_layers) for g in (dws[i], dbs[i])]
    return loss, dx, (*grads, dwl)


fused_tower_grad.launches = 0


def dense_paths(model_params) -> Sequence[Tuple[str, ...]]:
    """MLP param tree -> ordered paths (W1, b1, ..., Wk, bk, Wl) of the tower."""
    names = sorted(model_params["dnn"].keys(), key=lambda s: int(s.split("_")[1]))
    paths = []
    for n in names:
        paths.append(("dnn", n, "Dense_0", "kernel"))
        paths.append(("dnn", n, "Dense_0", "bias"))
    paths.append(("logit", "Dense_0", "Dense_0", "kernel"))
    return paths


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def make_fast_loss_grad(model, cfg, tower_grad: Callable = fused_tower_grad,
                        lookup: Callable = embedding_lookup):
    """Returns f(params, batch, seeds, train=True) -> (data_loss, grads).

    ``grads`` has the structure of ``params`` with ``None`` at frozen tables.
    ``tower_grad`` and ``lookup`` default to the kernels' wrappers; a check
    on the card passes the plain versions to compare a whole step.
    """
    dims = (
        int(model.user_dim) + int(model.item_dim) + int(model.domain_dim),
        *[int(h) for h in model.hidden_dim],
    )
    rate = float(model.dropout)
    u_dim, i_dim = int(model.user_dim), int(model.item_dim)
    l2 = float(cfg.l2_emb)
    emb_trainable = bool(cfg.emb_trainable)

    def loss_grad(params, batch, seeds, train: bool = True):
        mp = params["model"]
        emb = mp["embedding"]
        u = lookup(emb["user_emb"], batch["uid"])
        p = lookup(emb["item_emb"], batch["pid"])
        d = lookup(emb["domain_emb"], batch["domain"])
        x = torch.cat([u, p, d], dim=-1)

        paths = dense_paths(mp)
        dense = tuple(_get(mp, path) for path in paths)
        eff_rate = rate if train else 0.0
        data_loss, dx, dgrads = tower_grad(
            x, batch["label"], batch["weight"], seeds, dense, dims, eff_rate,
        )

        grads_model = trees.tree_map(lambda leaf: None, mp)
        for path, g in zip(paths, dgrads):
            _set(grads_model, path, g.reshape(_get(mp, path).shape))

        # embedding grads: scatter-add of dx slices + l2 terms (frozen
        # tables get none: the optimizer never reads them)
        ge = grads_model["embedding"]
        ge["domain_emb"] = (
            torch.zeros_like(emb["domain_emb"]).index_add_(
                0, batch["domain"].long(), dx[:, u_dim + i_dim :])
            + 2.0 * l2 * emb["domain_emb"]
        )
        if emb_trainable:
            ge["user_emb"] = (
                torch.zeros_like(emb["user_emb"]).index_add_(
                    0, batch["uid"].long(), dx[:, :u_dim])
                + 2.0 * l2 * emb["user_emb"]
            )
            ge["item_emb"] = (
                torch.zeros_like(emb["item_emb"]).index_add_(
                    0, batch["pid"].long(), dx[:, u_dim : u_dim + i_dim])
                + 2.0 * l2 * emb["item_emb"]
            )
        return data_loss, {"model": grads_model}

    return loss_grad
