"""Build and load the port's CUDA sources (``csrc/*.cu``).

Each source is compiled with nvcc on first use into ``build/kernels/`` at
the repository root, as a shared library with a plain C interface, keyed on
a hash of the source and the flags, and loaded with ctypes. `build` starts
one nvcc process per source that is not built yet, all at once, and waits
for them together.

A library links nvcc's default static CUDA runtime. Its launches still go
into a stream that PyTorch is capturing into a CUDA graph (both runtimes
share the context and its stream handles), and the launchers'
``cudaFuncSetAttribute`` and ``cudaGetLastError`` are legal during a
capture: tests/test_torch_jit.py and chip_smoke.py phase 15 capture every
kernel of the frame and the step and replay them bit for bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
# Sources built with -fmad=true in place of -fmad=false: csrc/shade.cu rounds
# each of its own operations with the _rn intrinsics, and under -fmad=true
# the math library's float64 pow rounds as PyTorch's kernels (built so)
# round it.
FMAD_SOURCES = ("shade",)
_loaded: dict[str, ctypes.CDLL] = {}


def _flags(name: str) -> tuple[str, ...]:
    if name not in FMAD_SOURCES:
        return NVCC_FLAGS
    return tuple("-fmad=true" if f == "-fmad=false" else f
                 for f in NVCC_FLAGS)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes()
                         + " ".join(_flags(name)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}_{key}.so"


def build(*names: str) -> dict[str, tuple[Path, str]]:
    """Compile ``csrc/<name>.cu`` for each name whose library is not built
    yet, in parallel. Returns {name: (shared library, compiler output)};
    the output is empty for a library that was already built."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    done, running = {}, {}
    for name in names:
        lib = _target(name)
        if lib.exists():
            done[name] = (lib, "")
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        log = lib.with_name(f"{lib.name}.{os.getpid()}.log")
        with open(log, "w") as f:
            proc = subprocess.Popen(
                [_nvcc(), *_flags(name), "-o", str(tmp),
                 str(CSRC / f"{name}.cu")],
                stdout=f, stderr=subprocess.STDOUT)
        running[name] = (lib, tmp, log, proc)
    failed = []
    for name, (lib, tmp, log, proc) in running.items():
        rc = proc.wait()
        text = log.read_text()
        log.unlink()
        if rc != 0:
            failed.append(f"nvcc failed on {name}.cu ({rc}):\n{text}")
            continue
        os.replace(tmp, lib)
        done[name] = (lib, text)
    if failed:
        raise RuntimeError("\n".join(failed))
    return done


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it if needed."""
    if name not in _loaded:
        (path, _), = build(name).values()
        _loaded[name] = ctypes.CDLL(str(path))
    return _loaded[name]
