"""The "pallas2" path's exact escalation (``RenderConfig.escalate_all``,
ROADMAP F7 and 6.4), on the CPU: a posed, rough 3,200-triangle sphere at
64x30, 32-triangle clusters, 3 candidates a tile, so that tiles overflow.

- Every pixel's triangle is the plain reference's nearest
  (``benchmark/reference/render.py``) or a tie within rounding by the
  benchmark's check (``benchmark/harness/check.py``), eagerly and through
  `render_jit`'s bucketed path (the captured path's twin on the CPU), and
  no tile keeps overflow; with the same settings the default escalation
  (64 tiles at most, at twice the candidates) leaves overflow and wrong
  pixels.
- The buckets: the tiles escalated and their candidates grow with the live
  counts (`utils/graphs.py` `GraphCache.regrown`, the span
  ``rt.graphs.regrow``), each frame bitwise the eager one, also in the
  compiled training step, and `utils/profiling.py` `escalate_fill` reads
  the last frame's tiles with overflow against their bucket.
- With the field off the frame is the one-pass escalation of the JAX
  package, restated here from the cull and K4's twin, bit for bit.
- On a CUDA device (``gpu`` marker, skipped here): the captured frame is
  the eager one, bitwise, at a bucket that fits and after a regrowth, and
  matches the reference; K4 at an escalated budget is its plain twin.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import cpp_cuda_raytracer_dev_torch as P
from cpp_cuda_raytracer_dev_torch.accel import traverse as tr
from cpp_cuda_raytracer_dev_torch.models import renderer
from cpp_cuda_raytracer_dev_torch.models.camera import set_up_frame
from cpp_cuda_raytracer_dev_torch.ops.quaternion import from_axis_angle
from cpp_cuda_raytracer_dev_torch.parallel.render_pjit import (
    make_train_step, make_train_step_jit)
from cpp_cuda_raytracer_dev_torch.utils import profiling
from cpp_cuda_raytracer_dev_torch.utils.graphs import GraphCache
from cpp_cuda_raytracer_dev_torch.utils.procgen import uv_sphere

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import check  # noqa: E402
from benchmark.reference import render as ref  # noqa: E402

RES_W, RES_H = 64, 30
GRAZING = (1.8, 0.3, 1.6)
SETTINGS = dict(method="pallas2", leaf_size=32, tile_h=8, tile_w=32,
                max_candidates=3, escalate_tiles=6, escalate_factor=2)
EXACT = P.RenderConfig(**SETTINGS, escalate_all=True)
DEFAULT = P.RenderConfig(**SETTINGS)
TRI_FIELDS = ("p1x", "p1y", "p1z", "e1x", "e1y", "e1z", "e2x", "e2y", "e2z")
CAMERA_FIELDS = ("pos", "look_at", "up", "film_w", "film_h", "focal")
PHONG_FIELDS = ("light_pos", "light_color", "diffuse", "specular",
                "exponent")
OUTPUTS = ("image", "radiance", "hit_t", "hit_tri", "hit_obj", "normal",
           "point")


def _scene(device="cpu"):
    tv = uv_sphere(40, 40, roughness=0.03)
    tris = P.Triangles.from_vertices(np.roll(tv, -tv.shape[0] // 2, axis=0),
                                     device=device)
    pose = P.Pose(from_axis_angle([0.3, 1.0, 0.1], 0.6, device=device),
                  torch.tensor([0.15, -0.1, 0.2], device=device))
    return P.Scene([P.SceneObject(tris, pose)],
                   P.PhongParams.reference(device=device))


@pytest.fixture(scope="module")
def world():
    scene = _scene()
    return scene, (P.ClusterAccel.build(scene.objects[0].tris,
                                        leaf_size=32, cache=False),)


def _camera(pos, device="cpu"):
    return P.Camera.create(RES_W, RES_H, pos=list(pos),
                           look_at=[0.15, -0.1, 0.2], up=[0.0, 1.0, 0.0],
                           film_h=0.024, focal=0.055, device=device)


@pytest.fixture
def frame_graphs(monkeypatch):
    cache = GraphCache()
    monkeypatch.setattr(renderer, "FRAME_GRAPHS", cache)
    return cache


def _left_overflow(scene, cam, accel, config) -> int:
    """Tiles that keep overflow after the escalation."""
    setup = set_up_frame(cam, [scene.objects[0].pose], "pallas2")
    frame = setup.objects[0]
    _, stats = tr.intersect_clustered_pallas_v2(
        frame.origin, frame.rays, accel[0],
        dataclasses.replace(config, with_stats=True), RES_H, RES_W)
    return int((stats["overflow"] > 0).sum())


def _pixels_off(scene, cam, out) -> int:
    """Pixels whose triangle is neither the reference's nearest nor a tie
    within rounding, or whose colour is off by more than one level."""
    t_ = scene.objects[0].tris
    pose = scene.objects[0].pose
    args = ({"geom": torch.stack([getattr(t_, n) for n in TRI_FIELDS], 1),
             "color": t_.color},
            {"quat": pose.quat, "translation": pose.translation},
            dict({k: getattr(cam, k) for k in CAMERA_FIELDS},
                 res_w=cam.res_w, res_h=cam.res_h),
            {k: getattr(scene.phong, k) for k in PHONG_FIELDS})
    prog = {"image": out.image.reshape(-1, 3),
            "radiance": out.radiance.reshape(-1, 3),
            "t": out.hit_t.reshape(-1), "tri": out.hit_tri.reshape(-1)}
    with torch.no_grad():
        want = ref.render(*args, False)
        chosen = ref.choice(*args, prog["tri"].long())
    return check.frame_numbers(prog, want, chosen)["off"]


def _assert_bitwise(a, b):
    for name in OUTPUTS:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("entry", ["render", "render_jit"])
def test_exact_escalation_picks_the_references_nearest_hit(
        world, frame_graphs, entry):
    scene, accel = world
    cam = _camera(GRAZING)
    frame = getattr(P, entry)
    exact = frame(scene, cam, EXACT, accel)
    assert float((exact.hit_tri >= 0).float().mean()) > 0.3
    assert _pixels_off(scene, cam, exact) == 0
    assert _left_overflow(scene, cam, accel, EXACT) == 0
    # the default's one escalation of at most 6 tiles leaves overflow,
    # and with it pixels whose nearest cluster was dropped
    default = frame(scene, cam, DEFAULT, accel)
    assert _left_overflow(scene, cam, accel, DEFAULT) > 0
    assert _pixels_off(scene, cam, default) > 100


def test_buckets_grow_with_the_live_counts(world, frame_graphs):
    """A far view probes the first bucket; a near one has more tiles with
    overflow and regrows it; the far view then fits the larger bucket.
    `escalate_fill` reads each frame's tiles with overflow against the
    tiles' bucket, and the bin tables' fill reads nothing."""
    scene, accel = world
    config = dataclasses.replace(EXACT, tile_w=16)
    far, near = _camera((0.0, 0.2, -10.0)), _camera((0.0, 0.2, -2.0))
    need = {c: renderer.escalation_count(scene, c, config, accel).tolist()
            for c in (far, near)}
    assert need[far][0] < need[near][0] and need[far][1] > need[near][1]
    assert need[far] == [4, 47] and need[near] == [16, 13]
    for cam, regrown, bucket in ((far, 0, (4, 64)), (near, 1, (16, 64)),
                                 (far, 1, (16, 64))):
        _assert_bitwise(P.render_jit(scene, cam, config, accel),
                        P.render(scene, cam, config, accel))
        assert frame_graphs.regrown == regrown
        # the tiles' bucket grew, the candidates' never shrank
        assert list(frame_graphs.buckets.values()) == [bucket]
        assert profiling.escalate_fill() == ([need[cam][0]], bucket[0])
        assert profiling.bin_fill() is None
    P.render_jit(scene, far, DEFAULT, accel)
    assert profiling.escalate_fill() is None


def test_a_regrowth_yields_its_span(world, frame_graphs):
    """The frame that outgrows its bucket runs one ``rt.graphs.regrow``
    inside its ``rt.render_jit``, and a live read before and after the
    redo; a frame that fits runs none."""
    from torch.profiler import ProfilerActivity, profile
    scene, accel = world
    config = dataclasses.replace(EXACT, tile_w=16)
    far, near = _camera((0.0, 0.2, -10.0)), _camera((0.0, 0.2, -2.0))
    P.render_jit(scene, far, config, accel)   # the probe, outside the profile
    for cam, regrows, lives in ((near, 1, 2), (far, 0, 1)):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            P.render_jit(scene, cam, config, accel)
        spans = [(e.name, e.time_range.start, e.time_range.end)
                 for e in prof.events() if e.name.startswith("rt.")]
        (entry,) = [x for x in spans if x[0] == "rt.render_jit"]
        for name, n in (("rt.graphs.regrow", regrows),
                        ("rt.graphs.live", lives)):
            got = [x for x in spans if x[0] == name]
            assert len(got) == n, name
            assert all(entry[1] <= x[1] and x[2] <= entry[2] for x in got)


def test_compiled_step_sizes_the_escalation_at_its_bucket(world):
    """`make_train_step_jit` with the exact escalation (its bucketed path
    on the CPU) takes the eager step's losses and parameters, bitwise."""
    _, accel = world
    target = torch.zeros(RES_H, RES_W, 3)
    runs = []
    for make in (make_train_step, make_train_step_jit):
        params = {"scene": _scene(), "camera": _camera(GRAZING)}
        pose = params["scene"].objects[0].pose
        step = make(torch.optim.SGD(pose.parameters(), lr=1e-3), EXACT,
                    accel=accel)
        runs.append([step(params, target) for _ in range(2)]
                    + [p.detach() for p in pose.parameters()])
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert not torch.equal(runs[1][-1], torch.tensor([0.15, -0.1, 0.2]))


def test_default_is_the_one_pass_escalation(world):
    """With the field off the frame is the JAX package's one escalation
    of the ``escalate_tiles`` tiles with the most overflow at
    ``max_candidates * escalate_factor``, restated from its parts."""
    scene, accel = world
    frame = set_up_frame(_camera(GRAZING), [scene.objects[0].pose],
                         "pallas2").objects[0]
    o, d, a, c = frame.origin, frame.rays, accel[0], DEFAULT
    tiles, meta = tr._tile_rays(d, RES_H, RES_W, c.tile_h, c.tile_w)
    cand, count, overflow = tr._cull(o, tiles, a, c, c.max_candidates)
    t, tri, _ = tr._run_v2_kernel(o, tiles.transpose(1, 2).contiguous(),
                                  cand, count, a, c, 1)
    etile = torch.sort(overflow, descending=True,
                       stable=True).indices[:c.escalate_tiles]
    cand2, count2, _ = tr.cull_tiles(o, tiles[etile], a, c.tile_h, c.tile_w,
                                     c.max_candidates * c.escalate_factor)
    t2, tri2, _ = tr._run_v2_kernel(
        o, tiles[etile].transpose(1, 2).contiguous(), cand2, count2, a, c, 1)
    t[etile], tri[etile] = t2, tri2
    want = tr._hit(t, tri, meta, RES_H, RES_W)
    got = tr.intersect_clustered_pallas_v2(o, d, a, c, RES_H, RES_W)
    assert torch.equal(got.t, want.t) and torch.equal(got.tri, want.tri)
    assert int((overflow > 0).sum()) > c.escalate_tiles


def _gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_captured_exact_frame_is_the_eager_one_gpu(frame_graphs):
    dev = _gpu()
    scene = _scene(dev)
    accel = (P.ClusterAccel.build(scene.objects[0].tris, leaf_size=32,
                                  cache=False),)
    config = dataclasses.replace(EXACT, tile_w=16)
    far, near = (_camera((0.0, 0.2, z), dev) for z in (-10.0, -2.0))
    for cam, regrown in ((far, 0), (near, 1), (far, 1), (near, 1)):
        _assert_bitwise(P.render_jit(scene, cam, config, accel),
                        P.render(scene, cam, config, accel))
        assert frame_graphs.regrown == regrown
    assert frame_graphs.captures == 2
    assert list(frame_graphs.buckets.values()) == [(16, 64)]
    cam = _camera(GRAZING, dev)
    out = P.render_jit(scene, cam, EXACT, accel)
    _assert_bitwise(out, P.render(scene, cam, EXACT, accel))
    assert _pixels_off(scene, cam, out) == 0
    assert _left_overflow(scene, cam, accel, EXACT) == 0


@pytest.mark.gpu
def test_k4_at_an_escalated_budget_is_its_twin_gpu():
    from cpp_cuda_raytracer_dev_torch.ops.cuda import tile_intersect as ti
    dev = _gpu()
    scene = _scene(dev)
    accel = P.ClusterAccel.build(scene.objects[0].tris, leaf_size=32,
                                 cache=False)
    frame = set_up_frame(_camera(GRAZING, dev), [scene.objects[0].pose],
                         "pallas2").objects[0]
    o = frame.origin
    tiles, _, _, _, _, overflow = tr._v2_cull(o, frame.rays, accel, EXACT,
                                              RES_H, RES_W)
    etile = torch.sort(overflow, descending=True, stable=True).indices
    e_tiles = tiles[etile]
    for k2 in (16, 64, accel.num_clusters):
        cand, count, ovf = tr.cull_tiles(o, e_tiles, accel, EXACT.tile_h,
                                         EXACT.tile_w, k2)
        boxes = tr._candidate_boxes(o, accel, cand, count)
        root = torch.cat([o, accel.bounds_min.amin(dim=0),
                          accel.bounds_max.amax(dim=0)])
        args = (e_tiles.transpose(1, 2).contiguous(), cand, count, boxes,
                root, accel.geom9, accel.slot_mat, EXACT.eps,
                EXACT.draw_distance)
        got = ti.tile_intersect_v2(*args)
        want = ti.tile_intersect_v2_reference(*args)
        for x, y in zip(got, want):
            assert torch.equal(x, y), k2
    assert int(ovf.sum()) == 0 and int(count.max()) > 16
