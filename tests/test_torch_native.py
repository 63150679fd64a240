"""The port's native KD builder (``accel/native.py`` + ``kd_native.cpp``)
against the port's numpy ``build_kd`` and the JAX package's native
builder: every array of the tree bit for bit, on random boxes made from
numpy seeds (as tests/test_native.py:26 validates them) and on a procgen
mesh's triangle boxes. The library is built into ``build/native/`` at the
repository root, never beside the source; ``ClusterAccel.build`` goes
through the native builder.
"""

from pathlib import Path

import numpy as np
import pytest

from cpp_cuda_raytracer_dev_tpu.accel import native as jnative
from cpp_cuda_raytracer_dev_torch.accel import native
from cpp_cuda_raytracer_dev_torch.accel.kd_build import build_kd, validate_kd
from cpp_cuda_raytracer_dev_torch.utils.procgen import dragon_class_mesh

KD_FIELDS = ("bounds_min", "bounds_max", "cut_code", "s1", "s2", "left",
             "right", "parent", "leaf_start", "leaf_count", "perm")
REPO = Path(__file__).resolve().parents[1]


def _boxes(seed, n=5000):
    rng = np.random.default_rng(seed)
    lo = rng.standard_normal((n, 3)).astype(np.float32)
    return lo, lo + rng.random((n, 3)).astype(np.float32)


def _mesh_boxes():
    v = dragon_class_mesh(6000, seed=2)
    return v.min(axis=1), v.max(axis=1)


def _assert_same(a, b, what):
    assert a.num_nodes == b.num_nodes, what
    for f in KD_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, (what, f)
        np.testing.assert_array_equal(x, y, err_msg=f"{what}: {f}")


def test_native_builds_into_build_dir():
    assert native.native_available(), native.build_error()
    lib = native.library_path()
    assert lib.exists() and lib.parent == REPO / "build" / "native"
    src = Path(native.__file__).parent
    assert not list(src.glob("*.so"))


@pytest.mark.parametrize("leaf", [1, 7, 32])
@pytest.mark.parametrize("case", ["random", "mesh"])
def test_native_matches_numpy_and_jax_native(case, leaf):
    lo, hi = _boxes(3) if case == "random" else _mesh_boxes()
    ref = build_kd(lo, hi, leaf)
    got = native.build_kd_native(lo, hi, leaf)
    _assert_same(ref, got, "numpy")
    if jnative.native_available():
        _assert_same(jnative.build_kd_native(lo, hi, leaf), got, "JAX native")
    validate_kd(got, lo, hi)


def _counting(monkeypatch):
    calls = []
    real = native.build_kd_native

    def counted(*args, **kwargs):
        calls.append(args[2:])
        return real(*args, **kwargs)
    monkeypatch.setattr(native, "build_kd_native", counted)
    return calls


def test_build_kd_fast_takes_the_native_builder(monkeypatch):
    calls = _counting(monkeypatch)
    lo, hi = _boxes(4, 300)
    tree = native.build_kd_fast(lo, hi, 8)
    assert calls == [(8,)]
    _assert_same(build_kd(lo, hi, 8), tree, "fast")


def test_cluster_accel_build_uses_the_native_builder(monkeypatch, tmp_path):
    import torch

    from cpp_cuda_raytracer_dev_torch import ClusterAccel, Triangles
    from cpp_cuda_raytracer_dev_torch.utils import cache

    calls = _counting(monkeypatch)
    monkeypatch.setattr(cache, "DEFAULT_CACHE_DIR", str(tmp_path))
    tris = Triangles.from_vertices(dragon_class_mesh(3000, seed=5),
                                   device="cpu")
    with torch.no_grad():
        accel = ClusterAccel.build(tris, leaf_size=32, cache=False)
        cached = ClusterAccel.build(tris, leaf_size=32)   # a cache miss
    assert len(calls) == 2
    assert int((accel.slot_mat >= 0).sum()) == tris.p1x.shape[0]
    assert torch.equal(accel.slot_mat, cached.slot_mat)
