"""ctypes bridge to the port's native CSV loader (``csrc/csv_loader.cc``).

Counterpart of ``mamdr_tpu/data/native_loader.py``. The library is built
with ``g++`` at first use, never at import, into ``mamdr_tpu_torch/_build/``
under a name that carries a hash of the source and flags (as the CUDA
kernels are, ``ops/_cuda.py``). Unlike the JAX bridge, a failed build or
load raises: a dataset is never parsed by numpy because the toolchain is
missing. A file the native parser itself refuses (a malformed row) is read
by ``load_csv_reference``, numpy's parser, as the JAX package reads it
(``mamdr_tpu/data/dataset.py:68-79``); that parser is also the plain version
the tests hold the native one to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "csv_loader.cc")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]

Columns = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _lib_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"libcsvloader-{digest[:12]}.so")


def _build(out: str) -> None:
    """Compile the library to `out` (a temporary name renamed into place, so
    processes that build at once never load a half-written file)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, SOURCE, "-o", tmp]
    try:
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native CSV loader: cannot run {cmd[0]}: {e}") from e
    if p.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"native CSV loader build failed (rc {p.returncode}):\n"
                           f"{p.stdout}{p.stderr}")
    os.replace(tmp, out)


def get_lib() -> ctypes.CDLL:
    """The loaded library, built on first use; raises if it cannot be."""
    global _lib
    with _lock:
        if _lib is None:
            path = _lib_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
            lib.csv_count_rows.argtypes = [ctypes.c_char_p]
            lib.csv_count_rows.restype = ctypes.c_int64
            i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            lib.csv_load.argtypes = [ctypes.c_char_p, i32, i32, i32, f32, ctypes.c_int64]
            lib.csv_load.restype = ctypes.c_int64
            _lib = lib
        return _lib


def load_csv_native(path: str) -> Optional[Columns]:
    """-> (uid int32, pid int32, domain int32, label float32), or None when
    the native parser refuses the file (a malformed row: the caller reads it
    with ``load_csv_reference``). ``load_csv_native.files`` counts the files
    it parsed."""
    lib = get_lib()
    n = lib.csv_count_rows(path.encode())
    if n < 0:
        return None
    uid = np.empty(n, np.int32)
    pid = np.empty(n, np.int32)
    domain = np.empty(n, np.int32)
    label = np.empty(n, np.float32)
    if lib.csv_load(path.encode(), uid, pid, domain, label, n) != n:
        return None
    load_csv_native.files += 1
    return uid, pid, domain, label


load_csv_native.files = 0


def load_csv_reference(path: str) -> Columns:
    """numpy's parse of the same file (the JAX package's fallback, kept bit
    for bit: float64 columns cast to int32 / float32)."""
    raw = np.genfromtxt(path, delimiter=",", skip_header=1, dtype=np.float64)
    if raw.size == 0:
        raw = np.zeros((0, 4))
    raw = np.atleast_2d(raw)
    return (raw[:, 0].astype(np.int32), raw[:, 1].astype(np.int32),
            raw[:, 2].astype(np.int32), raw[:, 3].astype(np.float32))
