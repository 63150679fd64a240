"""The frame's set-up (``models/camera.py`` `set_up_frame`), kernel K11 on
the card (``ops/cuda/shade.py`` `frame_setup`): the rays of a band of
rows, the camera Projection and each posed object's origin, rays and
Projection in the object's frame.

On the CPU:
- the plain version (`frame_setup_reference`, which `set_up_frame` runs
  for CPU tensors) returns bitwise what `Camera.ray_directions`,
  `Camera.projection`, `Projection.transformed` and `Pose.inv_apply(_vec)`
  return, for even and odd resolutions, a band with ``row0`` > 0, one and
  two objects, and float64 for "kd"; "bin" gets no object-frame rays;
  without ``rays`` it makes none, and the bin probe `bin_entry_count`
  counts the same entries without generating a ray;
- with autograd on and camera leaves that require grad, the plain version
  runs inside the autograd Function, K13's twin once in its backward: its
  rays alone carry gradients to the camera, and no kernel launches;
- a bin `render` with `Pose.inv_apply_vec` made to raise on rays (not on
  the Projection's vectors) renders bitwise the frame traced from the
  object-frame rays the bin path used to be given (it never read them).

On the card (marked ``gpu``; they skip here): K11 bitwise its plain
version in float32 and float64, with more objects than one launch serves
and with a band; `render_jit` frames of "bin" and "kd" at 960x540 bitwise
those of the same frames with the plain set-up; K11 and, in the
backward, K13 when autograd needs the set-up (a camera leaf that requires
grad; the plain version never runs), and K11 alone when only a pose
requires grad. The file imports no JAX:
    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_frame_setup.py
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import cpp_cuda_raytracer_dev_torch as P
from cpp_cuda_raytracer_dev_torch.models import camera as camera_mod
from cpp_cuda_raytracer_dev_torch.models import renderer
from cpp_cuda_raytracer_dev_torch.models.camera import (
    frame_setup_reference, object_frames, set_up_frame)
from cpp_cuda_raytracer_dev_torch.models.setup_grad import \
    frame_setup_grad_reference
from cpp_cuda_raytracer_dev_torch.ops.cuda import shade as k11
from cpp_cuda_raytracer_dev_torch.ops.quaternion import Pose, from_axis_angle
from cpp_cuda_raytracer_dev_torch.utils.config import METHODS
from cpp_cuda_raytracer_dev_torch.utils.graphs import GraphCache
from cpp_cuda_raytracer_dev_torch.utils.procgen import uv_sphere

PROJ_FIELDS = ("origin", "n", "u", "v", "sx", "sy", "adjust_x", "adjust_y")
FIELDS = ("image", "radiance", "hit_t", "hit_tri", "hit_obj", "normal",
          "point")
# name: (res_w, res_h, row0, band_h, objects, dtype, method)
CASES = {"even bin": (48, 32, 0, None, 1, torch.float32, "bin"),
         "odd bin two objects": (33, 19, 0, None, 2, torch.float32, "bin"),
         "band bin": (48, 32, 5, 7, 2, torch.float32, "bin"),
         "odd fixed two objects": (33, 19, 0, None, 2, torch.float32,
                                   "fixed"),
         "band raster": (33, 19, 4, 9, 1, torch.float32, "raster"),
         "kd float64": (48, 32, 0, None, 2, torch.float64, "kd"),
         "band kd float64": (33, 19, 6, 8, 1, torch.float64, "kd"),
         "nine objects": (48, 32, 0, None, 9, torch.float32, "fixed")}


def _poses(n, dtype, device):
    return [Pose(from_axis_angle([0.3, 1.0, 0.1], 0.4 * i + 0.2,
                                 device=device).to(dtype),
                 torch.tensor([0.3 * i - 0.5, 0.1 * i, 0.2 * (i % 2)],
                              dtype=dtype, device=device))
            for i in range(n)]


def _case(case, device, res=None):
    w, h, row0, band_h, n, dtype, method = CASES[case]
    w, h = res or (w, h)
    cam = P.Camera.create(w, h, pos=[0.1, 0.3, -3.0], look_at=[0.0, 0.1, 0.0],
                          up=[0.1, 1.0, 0.0], device=device, dtype=dtype)
    return cam, _poses(n, dtype, device), method, row0, band_h


def _assert_same_setup(got, want):
    assert (got.rmd is None) == (want.rmd is None)
    if want.rmd is not None:
        assert torch.equal(got.rmd, want.rmd)
        assert got.rmd.dtype == want.rmd.dtype
    assert (got.proj is None) == (want.proj is None)
    projs = [(got.proj, want.proj)] if want.proj is not None else []
    assert len(got.objects) == len(want.objects)
    for g, w in zip(got.objects, want.objects):
        assert torch.equal(g.origin, w.origin)
        assert (g.rays is None) == (w.rays is None)
        if w.rays is not None:
            assert torch.equal(g.rays, w.rays)
        assert (g.proj is None) == (w.proj is None)
        if w.proj is not None:
            projs.append((g.proj, w.proj))
    for g, w in projs:
        assert g.row0 == w.row0
        for f in PROJ_FIELDS:
            x, y = getattr(g, f), getattr(w, f)
            assert x.shape == y.shape and x.dtype == y.dtype, f
            assert torch.equal(x, y), f


@pytest.mark.parametrize("case", list(CASES))
def test_plain_setup_is_the_unfused_code(case):
    cam, poses, method, row0, band_h = _case(case, "cpu")
    before = k11.frame_setup.launches
    with torch.no_grad():
        got = set_up_frame(cam, poses, method, row0, band_h)
        w = cam.res_w
        rows = cam.res_h - row0 if band_h is None else band_h
        rmd = cam.ray_directions()[row0 * w:(row0 + rows) * w]
        proj = dataclasses.replace(cam.projection(), row0=row0)
    assert k11.frame_setup.launches == before
    assert torch.equal(got.rmd, rmd) and got.rmd.shape == (rows * w, 3)
    assert got.rmd.dtype == CASES[case][5]
    if METHODS[method].proj:
        assert got.proj.row0 == row0
        for f in PROJ_FIELDS:
            assert torch.equal(getattr(got.proj, f), getattr(proj, f)), f
    else:
        assert got.proj is None
    for pose, frame in zip(poses, got.objects, strict=True):
        assert torch.equal(frame.origin, pose.inv_apply(cam.pos))
        if not METHODS[method].object_rays:
            assert frame.rays is None
        else:
            assert torch.equal(frame.rays, pose.inv_apply_vec(rmd))
        if METHODS[method].proj:
            want = proj.transformed(pose)
            for f in PROJ_FIELDS:
                assert torch.equal(getattr(frame.proj, f),
                                   getattr(want, f)), f
        else:
            assert frame.proj is None


def test_band_rays_are_the_frame_rows():
    cam, poses, method, row0, band_h = _case("band bin", "cpu")
    with torch.no_grad():
        whole = frame_setup_reference(cam, poses, "fixed")
        band = frame_setup_reference(cam, poses, "fixed", row0, band_h)
    rows = slice(row0 * cam.res_w, (row0 + band_h) * cam.res_w)
    assert torch.equal(band.rmd, whole.rmd[rows])
    for b, w in zip(band.objects, whole.objects):
        assert torch.equal(b.rays, w.rays[rows])


def test_setup_without_rays_makes_none(monkeypatch):
    cam, poses, method, row0, band_h = _case("band bin", "cpu")
    with torch.no_grad():
        want = frame_setup_reference(cam, poses, method, row0, band_h)

    def refuse(self):
        raise AssertionError("rays generated")
    monkeypatch.setattr(P.Camera, "ray_directions", refuse)
    with torch.no_grad():
        got = set_up_frame(cam, poses, method, row0, band_h, rays=False)
    assert got.rmd is None
    want.rmd = None
    _assert_same_setup(got, want)


def test_bin_probe_generates_no_rays(monkeypatch):
    _, scene = _scene(2, "cpu")
    cam = P.Camera.create(64, 40, pos=[0.1, 0.3, -4.0], look_at=[0, 0, 0],
                          up=[0, 1, 0], device="cpu")
    config = P.RenderConfig(method="bin", bin_chunk=128)
    want = [renderer.bin_entry_count(scene, cam, config),
            renderer.bin_entry_count(scene, cam, config, 7, 21)]

    def refuse(self):
        raise AssertionError("the probe generated rays")
    monkeypatch.setattr(P.Camera, "ray_directions", refuse)
    got = [renderer.bin_entry_count(scene, cam, config),
           renderer.bin_entry_count(scene, cam, config, 7, 21)]
    assert got == want and min(got) > 0


def test_setup_with_autograd_takes_the_plain_version(monkeypatch):
    """On CPU tensors the Function's forward is the plain version and its
    backward K13's twin, called once; only the rays carry autograd."""
    cam, poses, _, _, _ = _case("odd bin two objects", "cpu")
    cam.requires_grad_()
    calls = []

    def twin(*args):
        calls.append(args[-1])
        return frame_setup_grad_reference(*args)
    monkeypatch.setattr(camera_mod, "frame_setup_grad_reference", twin)
    before = k11.frame_setup.launches
    setup = set_up_frame(cam, poses, "bin")
    assert k11.frame_setup.launches == before
    assert type(setup.rmd.grad_fn).__name__ == "_FrameSetupGradBackward"
    assert not any(getattr(setup.proj, f).requires_grad
                   for f in PROJ_FIELDS if f != "origin")
    assert not any(f.origin.requires_grad or f.proj.n.requires_grad
                   for f in setup.objects)
    setup.rmd.sum().backward()
    assert calls == [(True,) * 6]
    for name in P.Camera.LEAVES:
        assert getattr(cam, name).grad is not None, name
    with torch.no_grad():
        off = frame_setup_reference(cam, poses, "bin")
    _assert_same_setup(setup, off)


def _scene(n, device, dtype=torch.float32, sphere=24):
    tv = uv_sphere(sphere, sphere, roughness=0.03)
    color = np.random.default_rng(0).uniform(0.1, 1.0, (tv.shape[0], 3))
    tris = P.Triangles.from_vertices(tv, device=device, color=color,
                                     dtype=dtype)
    return tv, P.Scene([P.SceneObject(tris, p)
                        for p in _poses(n, dtype, device)])


def test_bin_render_reads_no_object_rays(monkeypatch):
    _, scene = _scene(2, "cpu")
    cam = P.Camera.create(64, 40, pos=[0.1, 0.3, -4.0], look_at=[0, 0, 0],
                          up=[0, 1, 0], device="cpu")
    config = P.RenderConfig(method="bin", bin_chunk=128)
    with torch.no_grad():
        rmd, proj = cam.ray_directions(), cam.projection()
        # the object frames with the rays the bin path was given before
        frames = object_frames([o.pose for o in scene.objects], cam.pos, rmd,
                               proj, "kd")
        frames = [dataclasses.replace(f, proj=proj.transformed(o.pose))
                  for f, o in zip(frames, scene.objects)]
        assert all(f.rays is not None for f in frames)
        flat = renderer.render_rays(scene, cam.pos, rmd, config, None,
                                    cam.res_h, cam.res_w, proj, frames)

    inv_apply_vec = Pose.inv_apply_vec

    def refuse(self, v):       # the Projection's (3,) vectors pass
        if v.dim() > 1:
            raise AssertionError("the bin path computed object-frame rays")
        return inv_apply_vec(self, v)
    monkeypatch.setattr(Pose, "inv_apply_vec", refuse)
    out = P.render(scene, cam, config)
    hits = out.hit_tri >= 0
    assert 0.2 < float(hits.float().mean()) < 0.95
    assert len(torch.unique(out.hit_obj[hits])) == 2
    for f in FIELDS:
        want = flat[f].reshape(getattr(out, f).shape)
        assert torch.equal(getattr(out, f), want), f


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_plain_version_on_gpu(case):
    _need_cuda()
    cam, poses, method, row0, band_h = _case(case, "cuda", (96, 64))
    before = k11.frame_setup.launches
    with torch.no_grad():
        got = set_up_frame(cam, poses, method, row0, band_h)
        torch.cuda.synchronize()
        want = frame_setup_reference(cam, poses, method, row0, band_h)
    assert k11.frame_setup.launches == before + max(
        1, math.ceil(len(poses) / k11.max_objects()))
    _assert_same_setup(got, want)
    if METHODS[method].proj:      # views of one buffer, as K8 takes them
        for f in PROJ_FIELDS:
            x = getattr(got.proj, f)
            assert x.is_contiguous() and x.shape == ((3,) if f in (
                "origin", "n", "u", "v") else ())


def _headline(method, device):
    tv, scene = _scene(1, device, sphere=200)
    cam = P.Camera.create(960, 540, pos=[0.1, 0.3, -3.0], look_at=[0, 0, 0],
                          up=[0, 1, 0], film_h=0.024, focal=0.055,
                          device=device)
    accel = None
    if method == "kd":
        from cpp_cuda_raytracer_dev_torch.accel.kd_build import build_kd
        tree = build_kd(tv.min(axis=1), tv.max(axis=1), min_node_size=32)
        accel = (P.KDTables.from_tree(tree, scene.objects[0].tris),)
    config = P.RenderConfig(method=method, bin_chunk=512, tile_h=16,
                            tile_w=32)
    return scene, cam, config, accel


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["bin", "kd"])
def test_replayed_frame_is_the_plain_setup_frame_on_gpu(method,
                                                        monkeypatch):
    _need_cuda()
    scene, cam, config, accel = _headline(method, "cuda")
    monkeypatch.setattr(renderer, "FRAME_GRAPHS", GraphCache())
    before = k11.frame_setup.launches
    for _ in range(2):
        got = P.render_jit(scene, cam, config, accel)
    assert k11.frame_setup.launches > before
    monkeypatch.setattr(renderer, "FRAME_GRAPHS", GraphCache())
    monkeypatch.setattr(renderer, "set_up_frame", frame_setup_reference)
    before = k11.frame_setup.launches
    for _ in range(2):
        want = P.render_jit(scene, cam, config, accel)
    assert k11.frame_setup.launches == before
    assert float((want.hit_tri >= 0).float().mean()) > 0.1
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.gpu
def test_no_launch_when_autograd_needs_the_setup_on_gpu(monkeypatch):
    """A camera leaf that requires grad: K11 forward inside the autograd
    Function (the plain version never runs) and K13 once in the backward;
    a pose that requires grad alone: K11 and no Function."""
    _need_cuda()
    cam, poses, _, _, _ = _case("odd bin two objects", "cuda", (96, 64))
    cam.requires_grad_()

    def refuse(*args, **kw):
        raise AssertionError("the plain set-up ran")
    with torch.no_grad():
        off = set_up_frame(cam, poses, "bin")
    monkeypatch.setattr(camera_mod, "frame_setup_reference", refuse)
    launches = k11.frame_setup.launches, k11.frame_setup_grad.launches
    setup = set_up_frame(cam, poses, "bin")
    assert (k11.frame_setup.launches, k11.frame_setup_grad.launches) == (
        launches[0] + 1, launches[1])
    assert type(setup.rmd.grad_fn).__name__ == "_FrameSetupGradBackward"
    assert not setup.proj.n.requires_grad and not any(
        f.origin.requires_grad for f in setup.objects)
    _assert_same_setup(setup, off)
    setup.rmd.sum().backward()
    assert (k11.frame_setup.launches, k11.frame_setup_grad.launches) == (
        launches[0] + 1, launches[1] + 1)
    assert all(p.grad is not None for p in cam.parameters())
    # a pose that requires grad: its object frame carries no autograd
    # either way, so K11 serves it without the Function
    cam.requires_grad_(False)
    poses[1].requires_grad_()
    posed = set_up_frame(cam, poses, "bin")
    assert (k11.frame_setup.launches, k11.frame_setup_grad.launches) == (
        launches[0] + 2, launches[1] + 1)
    assert posed.rmd.grad_fn is None
    _assert_same_setup(posed, off)


@pytest.mark.gpu
def test_kernel_without_rays_on_gpu():
    _need_cuda()
    cam, poses, method, row0, band_h = _case("band bin", "cuda", (96, 64))
    before = k11.frame_setup.launches
    with torch.no_grad():
        got = set_up_frame(cam, poses, method, row0, band_h, rays=False)
        torch.cuda.synchronize()
        want = frame_setup_reference(cam, poses, method, row0, band_h,
                                     rays=False)
    assert k11.frame_setup.launches == before + 1 and got.rmd is None
    _assert_same_setup(got, want)
