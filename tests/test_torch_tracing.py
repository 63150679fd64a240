"""The port's spans and set-up tallies (`utils/profiling.py`) on the CPU,
at tiny sizes:

- with no profiler recording, `span` enters no profiler range: a bin
  `render_jit` frame and a bin `make_train_step_jit` step run with the
  range made to raise;
- under ``torch.profiler.profile`` a bin frame yields one ``rt.render_jit``
  with ``rt.graphs.live`` inside it, a bin step one ``rt.train_step`` with
  ``rt.graphs.live`` inside it, and a kd frame no ``rt.graphs.live`` (it
  has no live count);
- `build_kd_fast` and `KDTables.from_tree` raise the ``kd_build_s`` tally,
  the native builder's first compile does not, and a new key's probe frame raises ``capture_s`` (a graph's capture
  needs the card).

There is no graph on the CPU, so no ``rt.graphs.launch``.
"""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import cpp_cuda_raytracer_dev_torch as P
from cpp_cuda_raytracer_dev_torch.accel import native
from cpp_cuda_raytracer_dev_torch.accel.native import build_kd_fast
from cpp_cuda_raytracer_dev_torch.accel.traverse import KDTables
from cpp_cuda_raytracer_dev_torch.models import renderer
from cpp_cuda_raytracer_dev_torch.parallel.render_pjit import \
    make_train_step_jit
from cpp_cuda_raytracer_dev_torch.utils import graphs, profiling
from cpp_cuda_raytracer_dev_torch.utils.procgen import uv_sphere

RES_W, RES_H = 48, 32
BIN = P.RenderConfig(method="bin", bin_chunk=128)
KD = P.RenderConfig(method="kd")


@pytest.fixture
def frame_graphs(monkeypatch):
    """A fresh frame cache, so that the first frame of a test probes."""
    cache = graphs.GraphCache()
    monkeypatch.setattr(renderer, "FRAME_GRAPHS", cache)
    return cache


def _vertices():
    return np.roll(uv_sphere(12, 12), -72, axis=0)


def _scene(tv):
    tris = P.Triangles.from_vertices(tv, device="cpu")
    return P.Scene([P.SceneObject(tris)])


def _camera():
    return P.Camera.create(RES_W, RES_H, pos=[0.1, 0.3, -3.0],
                           look_at=[0, 0, 0], up=[0, 1, 0], film_h=0.024,
                           focal=0.055, device="cpu")


def _kd_tables(tv):
    tree = build_kd_fast(tv.min(axis=1), tv.max(axis=1), 8)
    return (KDTables.from_tree(tree, P.Triangles.from_vertices(
        tv, device="cpu")),)


def _step():
    """A compiled bin step and its arguments, its first step taken."""
    scene, cam = _scene(_vertices()), _camera().requires_grad_()
    params = {"scene": scene, "camera": cam}
    target = torch.full((RES_H, RES_W, 3), 0.5)
    opt = torch.optim.SGD([*scene.parameters(), *cam.parameters()], lr=1e-4)
    step = make_train_step_jit(opt, BIN)
    step(params, target)
    return step, params, target


def _spans(prof) -> list:
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name.startswith("rt.")]


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return _spans(prof)


def test_spans_enter_no_range_without_a_profiler(frame_graphs, monkeypatch):
    def refuse(name):
        raise AssertionError(f"span {name!r} entered a profiler range")
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    scene, cam = _scene(_vertices()), _camera()
    out = P.render_jit(scene, cam, BIN)
    assert (out.hit_tri >= 0).any()
    step, params, target = _step()
    assert torch.isfinite(step(params, target))


def test_bin_frame_yields_its_entry_and_live_spans(frame_graphs):
    scene, cam = _scene(_vertices()), _camera()
    P.render_jit(scene, cam, BIN)          # the probe, outside the profile
    spans = _profiled(lambda: P.render_jit(scene, cam, BIN))
    entry = [s for s in spans if s[0] == "rt.render_jit"]
    live = [s for s in spans if s[0] == "rt.graphs.live"]
    assert len(entry) == 1 and len(live) == 1
    assert _inside(live[0], entry[0])
    assert not [s for s in spans if s[0] == "rt.graphs.launch"]


def test_bin_step_yields_its_entry_and_live_spans():
    step, params, target = _step()
    spans = _profiled(lambda: step(params, target))
    entry = [s for s in spans if s[0] == "rt.train_step"]
    live = [s for s in spans if s[0] == "rt.graphs.live"]
    assert len(entry) == 1 and len(live) == 1
    assert _inside(live[0], entry[0])


def test_kd_frame_has_no_live_span(frame_graphs):
    tv = _vertices()
    scene, cam, accel = _scene(tv), _camera(), _kd_tables(tv)
    spans = _profiled(lambda: P.render_jit(scene, cam, KD, accel))
    assert [s[0] for s in spans] == ["rt.render_jit"]


def test_kd_build_raises_its_tally():
    tv = _vertices()
    before = profiling.SETUP_S["kd_build_s"]
    tree = build_kd_fast(tv.min(axis=1), tv.max(axis=1), 8)
    built = profiling.SETUP_S["kd_build_s"]
    KDTables.from_tree(tree, P.Triangles.from_vertices(tv, device="cpu"))
    assert before < built < profiling.SETUP_S["kd_build_s"]


def test_kd_build_tally_leaves_out_the_compile(monkeypatch, tmp_path):
    """A first call that compiles the native builder (here a compile of
    0.5 s that fails, so the numpy builder runs) counts only the build."""
    def compile_(lib):
        time.sleep(0.5)
        raise OSError("no compiler")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    monkeypatch.setattr(native, "library_path", lambda: tmp_path / "k.so")
    monkeypatch.setattr(native, "_compile", compile_)
    tv = _vertices()
    before = profiling.SETUP_S["kd_build_s"]
    build_kd_fast(tv.min(axis=1), tv.max(axis=1), 8)
    assert native.build_error() == "OSError: no compiler"
    assert 0 < profiling.SETUP_S["kd_build_s"] - before < 0.5


def test_probe_raises_the_capture_tally(frame_graphs):
    scene, cam = _scene(_vertices()), _camera()
    before = profiling.SETUP_S["capture_s"]
    P.render_jit(scene, cam, BIN)
    probed = profiling.SETUP_S["capture_s"]
    assert probed > before and frame_graphs.buckets
    P.render_jit(scene, cam, BIN)          # the key's bucket: no probe
    assert profiling.SETUP_S["capture_s"] == probed
