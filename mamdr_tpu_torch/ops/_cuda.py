"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface and loaded with ``ctypes`` — no PyTorch
headers, so a build takes seconds. Builds happen at first use, never at
import (the CPU tests import every module), one ``nvcc`` per source, all
started together. Libraries land in ``mamdr_tpu_torch/_build/`` under a name
that carries a hash of the source and flags, so an edited source rebuilds.

Every C entry point returns the ``cudaError_t`` of its launches; ``check``
turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Sequence

import torch

from mamdr_tpu_torch.utils import trace

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("fused_mlp_step", "gather_rows", "gather_rows_pipelined")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_variant: List[str] = []  # extra nvcc flags of a diagnostic build (see build_variant)
# What the last build printed (nvcc's -Xptxas -v register / shared-memory
# report per kernel) and how long it took; chip_smoke.py prints both.
build_log: Dict[str, str] = {}
build_seconds: Dict[str, float] = {}
trace.register(lambda: {f"build_s.{n}": s for n, s in build_seconds.items()})


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS + _variant).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}-{digest[:12]}.so")


def build_variant(extra: Sequence[str]) -> None:
    """From now on build and load every source with `extra` nvcc flags after
    the package's own: the -D switches of a timing-only build
    (``k1_ablation.py``, ``probe_gather.py --sweep``). ``()`` goes back to the
    port's build. A variant's libraries carry their own hash, so the port's
    are never overwritten; a caller that caches a bound entry clears it."""
    with _lock:
        _variant[:] = list(extra)
        _libs.clear()


def build() -> None:
    """Compile every missing library of SOURCES, in parallel; raise with
    nvcc's output if any build fails."""
    todo = [n for n in SOURCES if not os.path.exists(_lib_path(n))]
    if not todo:
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    t0 = time.perf_counter()
    for n in todo:
        out = _lib_path(n)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, *_variant, "-o", tmp, os.path.join(CSRC, n + ".cu")]
        procs.append((n, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed: List[str] = []
    for n, out, tmp, p in procs:
        log, _ = p.communicate()
        build_log[n] = log
        build_seconds[n] = time.perf_counter() - t0
        if p.returncode != 0:
            failed.append(f"--- nvcc {n}.cu (rc {p.returncode}) ---\n{log}")
            if os.path.exists(tmp):
                os.remove(tmp)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build()
            lib = ctypes.CDLL(_lib_path(name))
            _libs[name] = lib
        return lib


def stream_ptr(device: torch.device) -> int:
    """PyTorch's current CUDA stream on `device`, as an integer handle."""
    return torch.cuda.current_stream(device).cuda_stream


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (132 on an H100 SXM)."""
    return _sm_count(device.index if device.index is not None else torch.cuda.current_device())


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def require_cuda(t: torch.Tensor, name: str, dtype: torch.dtype) -> None:
    """Kernel input contract: a contiguous CUDA tensor of `dtype`."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
