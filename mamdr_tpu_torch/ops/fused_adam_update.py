"""The train step's flat Adam, its apply and its all-pad gate as one pass.

``fused_adam_update`` takes the trainable leaves of one tower (slots [n])
or of L lanes (every leaf [L, ...], slots [L, n]) with their gradients and
Adam's flat slots ``mu`` / ``nu`` (leaf order, as ``train/flat_optimizer.py``
lays them out), the bias corrections of the step and which lanes' batches
hold data, and returns the new leaves and slots: Adam's update applied
where a lane has data, everything as it was where it has none. On CUDA
tensors it launches kernel K4 (``csrc/fused_adam_update.cu``): one streaming
pass that reads p, g, mu and nu and writes p', mu' and nu' into fresh
buffers, which replaces a torch.cat, about 18 elementwise passes of Adam,
an add a leaf and three ``torch.where``s. K4 replaces no TPU kernel (the
JAX package leaves these ops to XLA's fusion); it was added because those
eager passes moved about 43 slabs of [L, n] floats a step where 7 do.

On CPU tensors it runs ``adam_update_reference``, the plain version: the
ops ``FlatAdam.update``, ``apply_updates`` and the train step's gate ran
before K4, unchanged. K4 computes the same operations in the same order in
float32, so the two agree bit for bit on the card. ``adam_plan`` is K4's
launch in plain Python: each leaf's slot offset, its tiles, whether it
takes the float4 path, and the launches (at most ``K4_MAX_LEAVES`` leaves a
launch), so what surrounds the kernel is tested without a card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from mamdr_tpu_torch.ops import _cuda
from mamdr_tpu_torch.utils import trace

K4_MAX_LEAVES = 48  # leaves a launch (csrc/fused_adam_update.cu kMaxLeaves)
K4_TILE = 4096      # elements of one leaf in one lane a block (kTile)


class AdamLaunch(NamedTuple):
    """One launch of K4: its leaves (indices into the plan's), each leaf's
    first tile in a lane, the tiles of a lane and the grid (lanes * tiles)."""
    leaves: Tuple[int, ...]
    tile0: Tuple[int, ...]
    tiles: int
    blocks: int


class AdamPlan(NamedTuple):
    lanes: int
    slots: int                     # n: a lane's slots, the leaves' elements a lane
    offsets: Tuple[int, ...]       # each leaf's first slot
    vec: Tuple[bool, ...]          # each leaf on the float4 path
    launches: Tuple[AdamLaunch, ...]


def adam_plan(numels: Sequence[int], lanes: int,
              aligned: Optional[Sequence[bool]] = None) -> AdamPlan:
    """Kernel K4's launches, in plain Python, for leaves of ``numels``
    elements a lane over ``lanes`` lanes. A leaf's slots start where the
    leaf before it ends (leaf order); it takes the float4 path when its
    elements a lane, its slot offset and the slot count are multiples of 4
    and ``aligned[i]`` (the caller's check that every base address the leaf
    reads or writes is 16-byte aligned; all by default), else the scalar
    path. Leaves without elements get no tile. Raises ``ValueError`` for no
    lane, a negative count, or a grid past the card's."""
    numels = [int(n) for n in numels]
    if lanes < 1:
        raise ValueError(f"K4 needs at least one lane, got {lanes}")
    if any(n < 0 for n in numels):
        raise ValueError(f"negative leaf sizes {numels}")
    aligned = [True] * len(numels) if aligned is None else [bool(a) for a in aligned]
    if len(aligned) != len(numels):
        raise ValueError("one alignment flag a leaf")
    slots = sum(numels)
    offsets, off = [], 0
    for n in numels:
        offsets.append(off)
        off += n
    vec = tuple(a and n % 4 == 0 and o % 4 == 0 and slots % 4 == 0
                for a, n, o in zip(aligned, numels, offsets))
    live = [i for i, n in enumerate(numels) if n > 0]
    launches = []
    for start in range(0, len(live), K4_MAX_LEAVES):
        leaves = tuple(live[start:start + K4_MAX_LEAVES])
        tile0, tiles = [], 0
        for i in leaves:
            tile0.append(tiles)
            tiles += -(-numels[i] // K4_TILE)
        if lanes * tiles >= 2**31:
            raise ValueError(f"K4's grid of {lanes} x {tiles} tiles is past the card's")
        launches.append(AdamLaunch(leaves, tuple(tile0), tiles, lanes * tiles))
    return AdamPlan(lanes, slots, tuple(offsets), vec, tuple(launches))


def adam_moments(g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor, bc1: torch.Tensor,
                 bc2: torch.Tensor, lr: float, b1: float, b2: float, eps: float):
    """(step, mu', nu') of Adam on the joined gradients ``g`` [*lead, n],
    ``bc1`` / ``bc2`` being ``1 - b**count`` shaped [*lead, 1]: the plain
    arithmetic K4 repeats, op for op (``FlatAdam.update`` runs it too)."""
    mu_new = b1 * mu + (1.0 - b1) * g
    nu_new = b2 * nu + (1.0 - b2) * (g * g)
    mu_hat = mu_new / bc1
    nu_hat = nu_new / bc2
    return -lr * mu_hat / (torch.sqrt(nu_hat) + eps), mu_new, nu_new


def adam_update_reference(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                          mu: torch.Tensor, nu: torch.Tensor, bc1: torch.Tensor,
                          bc2: torch.Tensor, has_data: torch.Tensor, lr: float, b1: float,
                          b2: float, eps: float):
    """The plain version (any device): (params', mu', nu') by the ops the
    train step ran before K4 — the gradients joined into [*lead, n], Adam's
    moments and step (``adam_moments``, as ``FlatAdam.update``), ``p + u`` a
    leaf (``apply_updates``), and ``torch.where`` of each output against its
    input on ``has_data`` (the all-pad gate)."""
    lead = mu.shape[:-1]  # () or (L,)
    g = torch.cat([x.reshape(*lead, -1) for x in grads], dim=-1)
    step, mu_new, nu_new = adam_moments(g, mu, nu, bc1, bc2, lr, b1, b2, eps)
    pieces = torch.split(step, [x[(0,) * len(lead)].numel() for x in grads], dim=-1)
    new_params = [p + u.reshape(p.shape) for p, u in zip(params, pieces)]
    return ([gated(has_data, n, p) for n, p in zip(new_params, params)],
            gated(has_data, mu_new, mu), gated(has_data, nu_new, nu))


def gated(has_data: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """The all-pad gate of one tensor: ``new`` in the lanes whose
    ``has_data`` is true, ``old`` elsewhere (``has_data`` [] or [L], the
    tensors with as many leading axes)."""
    return torch.where(has_data[(...,) + (None,) * (new.dim() - has_data.dim())], new, old)


class _Leaf(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p), ("g", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("numel", ctypes.c_longlong), ("p_stride", ctypes.c_longlong),
                ("slot", ctypes.c_longlong), ("tile0", ctypes.c_longlong),
                ("vec", ctypes.c_int), ("pad", ctypes.c_int)]


class _Plan(ctypes.Structure):
    """The kernel's ``Plan``, passed by pointer and copied by value into the
    launch's parameters."""
    _fields_ = [("leaf", _Leaf * K4_MAX_LEAVES),
                ("mu", ctypes.c_void_p), ("nu", ctypes.c_void_p),
                ("mu_out", ctypes.c_void_p), ("nu_out", ctypes.c_void_p),
                ("bc1", ctypes.c_void_p), ("bc2", ctypes.c_void_p),
                ("has_data", ctypes.c_void_p),
                ("slots", ctypes.c_longlong), ("mu_stride", ctypes.c_longlong),
                ("nu_stride", ctypes.c_longlong), ("tiles", ctypes.c_longlong),
                ("n_leaves", ctypes.c_int), ("lanes", ctypes.c_int),
                ("b1", ctypes.c_float), ("c1", ctypes.c_float), ("b2", ctypes.c_float),
                ("c2", ctypes.c_float), ("neg_lr", ctypes.c_float), ("eps", ctypes.c_float)]


@functools.lru_cache(maxsize=None)
def _bind():
    """The kernel entry of the built library, bound once."""
    lib = _cuda.load("fused_adam_update")
    if (lib.mamdr_adam_update_plan_bytes() != ctypes.sizeof(_Plan)
            or lib.mamdr_adam_update_tile() != K4_TILE
            or lib.mamdr_adam_update_max_leaves() != K4_MAX_LEAVES):
        raise RuntimeError("fused_adam_update: the library's Plan and its ctypes mirror differ")
    fn = lib.mamdr_adam_update
    fn.argtypes = [ctypes.POINTER(_Plan), ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _aligned(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def _lane_stride(x: torch.Tensor, lanes: int, name: str) -> int:
    """Elements between the lanes of ``x`` as K4 reads it: a lane's count
    where ``x`` is contiguous, 0 where it is one contiguous lane broadcast
    over a leading lane axis (``expand``'s view: a lane state before its
    first step). Raises ``ValueError`` for any other layout."""
    if x.is_contiguous():
        return x.numel() // lanes
    if x.dim() >= 1 and x.shape[0] == lanes and x.stride(0) == 0 and x[0].is_contiguous():
        return 0
    raise ValueError(f"{name} must be contiguous, or one contiguous lane broadcast over "
                     f"the lanes")


def _require(t: torch.Tensor, name: str, dtype: torch.dtype) -> None:
    """K4's operand contract short of contiguity (``_lane_stride`` checks it)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")


def _launch_k4(params, grads, mu, nu, bc1, bc2, has_data, lr, b1, b2, eps):
    for name, t in (("bc1", bc1), ("bc2", bc2)):
        _cuda.require_cuda(t, name, torch.float32)
    _cuda.require_cuda(has_data, "has_data", torch.bool)
    _require(mu, "mu", torch.float32)
    _require(nu, "nu", torch.float32)
    for i, (p, g) in enumerate(zip(params, grads)):
        _require(p, f"leaf {i}", torch.float32)
        _cuda.require_cuda(g, f"gradient {i}", torch.float32)
        if g.shape != p.shape:
            raise ValueError(f"leaf {i} is {tuple(p.shape)}, its gradient {tuple(g.shape)}")
    dev = mu.device
    if any(t.device != dev for t in (nu, bc1, bc2, has_data, *params, *grads)):
        raise ValueError("fused_adam_update: every operand must be on one device")
    if mu.dim() not in (1, 2) or nu.shape != mu.shape:
        raise ValueError(f"slots must be [n] or [L, n], got mu {tuple(mu.shape)}, "
                         f"nu {tuple(nu.shape)}")
    lanes = mu.shape[0] if mu.dim() == 2 else 1
    if bc1.numel() != lanes or bc2.numel() != lanes or has_data.numel() != lanes:
        raise ValueError(f"bc1, bc2 and has_data need one value a lane ({lanes})")
    if mu.dim() == 2 and any(p.dim() < 1 or p.shape[0] != lanes for p in params):
        raise ValueError(f"every leaf of a lane-stacked state needs a leading {lanes}")
    numels = [p.numel() // lanes for p in params]
    if sum(numels) != mu.shape[-1]:
        raise ValueError(f"the leaves hold {sum(numels)} elements a lane, the slots "
                         f"{mu.shape[-1]}")
    strides = [_lane_stride(p, lanes, f"leaf {i}") for i, p in enumerate(params)]
    mu_stride, nu_stride = _lane_stride(mu, lanes, "mu"), _lane_stride(nu, lanes, "nu")
    outs = [torch.empty(p.shape, dtype=p.dtype, device=dev) for p in params]
    mu_out = torch.empty(mu.shape, dtype=mu.dtype, device=dev)
    nu_out = torch.empty(nu.shape, dtype=nu.dtype, device=dev)
    slots_ok = _aligned(mu, nu, mu_out, nu_out)
    plan = adam_plan(numels, lanes,
                     [slots_ok and _aligned(p, g, o) for p, g, o in zip(params, grads, outs)])
    c = _Plan(mu=mu.data_ptr(), nu=nu.data_ptr(), mu_out=mu_out.data_ptr(),
              nu_out=nu_out.data_ptr(), bc1=bc1.data_ptr(), bc2=bc2.data_ptr(),
              has_data=has_data.data_ptr(), slots=plan.slots, mu_stride=mu_stride,
              nu_stride=nu_stride, lanes=lanes, b1=b1, c1=1.0 - b1, b2=b2, c2=1.0 - b2,
              neg_lr=-lr, eps=eps)
    stream = _cuda.stream_ptr(dev)
    for launch in plan.launches:
        c.n_leaves, c.tiles = len(launch.leaves), launch.tiles
        for k, (i, t0) in enumerate(zip(launch.leaves, launch.tile0)):
            c.leaf[k] = _Leaf(params[i].data_ptr(), grads[i].data_ptr(), outs[i].data_ptr(),
                              numels[i], strides[i], plan.offsets[i], t0, int(plan.vec[i]), 0)
        _cuda.check(_bind()(ctypes.byref(c), launch.blocks, stream), "fused_adam_update")
        fused_adam_update.launches += 1
    return outs, mu_out, nu_out


def fused_adam_update(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                      mu: torch.Tensor, nu: torch.Tensor, bc1: torch.Tensor,
                      bc2: torch.Tensor, has_data: torch.Tensor, lr: float, b1: float,
                      b2: float, eps: float) -> Tuple[List[torch.Tensor], torch.Tensor,
                                                      torch.Tensor]:
    """Adam's step, applied and gated: (params', mu', nu').

    ``params`` / ``grads``: the trainable leaves in leaf order, each [...]
    (one tower, slots ``mu`` / ``nu`` [n]) or [L, ...] (L lanes, slots
    [L, n]); ``bc1`` / ``bc2``: ``1 - b1**count`` / ``1 - b2**count`` of the
    step's count, one a lane ([*lead, 1]); ``has_data``: bool, one a lane.
    Lane l's leaves and slots move by Adam on lane l's gradients where
    ``has_data[l]``, and are returned as they were where not. The results
    are fresh tensors; the inputs are not written.

    CUDA tensors go through kernel K4: one launch for up to
    ``K4_MAX_LEAVES`` leaves, each counted in ``fused_adam_update.launches``.
    A leaf and the slots may be contiguous or one lane broadcast over the
    lanes (``_lane_stride``); gradients, ``bc1``, ``bc2`` and ``has_data`` are
    contiguous. A CUDA call K4 does not take (an operand not float32, a
    layout other than those, shapes that disagree, operands on two devices)
    raises. CPU tensors run ``adam_update_reference``."""
    params, grads = list(params), list(grads)
    if len(params) != len(grads):
        raise ValueError(f"{len(params)} leaves and {len(grads)} gradients")
    operands = (mu, nu, bc1, bc2, has_data, *params, *grads)
    if all(t.device.type == "cpu" for t in operands):
        return adam_update_reference(params, grads, mu, nu, bc1, bc2, has_data, lr, b1, b2,
                                     eps)
    return _launch_k4(params, grads, mu, nu, bc1, bc2, has_data, lr, b1, b2, eps)


fused_adam_update.launches = 0

trace.register(lambda: {"k4.launches": fused_adam_update.launches})
