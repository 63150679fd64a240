"""ctypes binding and first-use build of the native KD builder (the JAX
package's ``accel/native.py``).

`build_kd_native` is a drop-in replacement for `kd_build.build_kd`, with
the same tree bit for bit (tests/test_torch_native.py); `build_kd_fast`
takes the native builder when a C++ compiler is there and the numpy one
otherwise. The shared library is compiled once with g++ into
``build/native/`` at the repository root (git-ignored), keyed on a hash of
the source and the flags, never beside the source. Whether the native
builder is in use is visible: `native_available()` says so, and
`build_error()` says why not.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..utils.profiling import tally
from .kd_build import KDTree, build_kd

SRC = Path(__file__).resolve().with_name("kd_native.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-shared",
             "-fPIC")
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_error: str | None = None


def library_path() -> Path:
    key = hashlib.sha256(SRC.read_bytes()
                         + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libkdnative_{key}.so"


def _compile(lib: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC)],
                   check=True, capture_output=True, timeout=120)
    os.replace(tmp, lib)     # atomic: concurrent builders never see half


def _load() -> ctypes.CDLL | None:
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        lib_path = library_path()
        if not lib_path.exists():
            try:
                _compile(lib_path)
            except (subprocess.SubprocessError, OSError) as e:
                _build_error = f"{type(e).__name__}: {e}"
                return None
        lib = ctypes.CDLL(str(lib_path))
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.kd_build.restype = ctypes.c_int64
        lib.kd_build.argtypes = [
            f32p, f32p, ctypes.c_int64, ctypes.c_int64,
            f32p, f32p, i8p, f32p, f32p, i32p, i32p, i32p, i32p, i32p, i64p,
        ]
        _lib = lib
        return lib


def native_available() -> bool:
    """True when the native builder is built (or builds now) and loads."""
    return _load() is not None


def build_error() -> str | None:
    """Why the native builder is unavailable, or None."""
    _load()
    return _build_error


def build_kd_native(aabb_min: np.ndarray, aabb_max: np.ndarray,
                    min_node_size: int = 1) -> KDTree:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native KD builder unavailable: {_build_error}")
    amin = np.ascontiguousarray(aabb_min, np.float32)
    amax = np.ascontiguousarray(aabb_max, np.float32)
    n = amin.shape[0]
    cap = 2 * n
    out = dict(
        bounds_min=np.zeros((cap, 3), np.float32),
        bounds_max=np.zeros((cap, 3), np.float32),
        cut_code=np.zeros(cap, np.int8),
        s1=np.zeros(cap, np.float32), s2=np.zeros(cap, np.float32),
        left=np.full(cap, -1, np.int32), right=np.full(cap, -1, np.int32),
        parent=np.zeros(cap, np.int32),
        leaf_start=np.full(cap, -1, np.int32),
        leaf_count=np.zeros(cap, np.int32),
    )
    perm = np.zeros(n, np.int64)
    num = lib.kd_build(amin, amax, n, min_node_size,
                       out["bounds_min"], out["bounds_max"],
                       out["cut_code"], out["s1"], out["s2"], out["left"],
                       out["right"], out["parent"], out["leaf_start"],
                       out["leaf_count"], perm)
    if num <= 0:
        raise RuntimeError(f"kd_build failed: {num}")
    return KDTree(**{k: v[:num] for k, v in out.items()}, perm=perm,
                  min_node_size=min_node_size)


def build_kd_fast(aabb_min: np.ndarray, aabb_max: np.ndarray,
                  min_node_size: int = 1) -> KDTree:
    """Native if possible (`native_available`), numpy otherwise; the
    build's host seconds count in ``kd_build_s`` (`utils/profiling.py`),
    the first call's compile of the native builder not."""
    native = native_available()
    with tally("kd_build_s"):
        if native:
            return build_kd_native(aabb_min, aabb_max, min_node_size)
        return build_kd(aabb_min, aabb_max, min_node_size)
