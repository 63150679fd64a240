"""Kernel K14 (``csrc/tile_intersect.cu`` `cluster_cull_kernel`, launched by
``ops/cuda/tile_intersect.py`` `cluster_cull`): one launch per cull pass of
the cluster paths, against its plain twin in ``accel/traverse.py``
(`cull_tiles_reference`, `cull_tiles_hier_reference`, `_candidate_boxes`).

- On the CPU: `cull_tiles` and `cull_tiles_hier` take the twin for CPU
  tensors (K14's counter stays put) and the boxes of a cull are
  `_candidate_boxes`'s; the launcher refuses CPU tensors; the twin's
  three-term dot products, written out in one order so that K14 can
  repeat them, are the CPU's sum bit for bit.
- On a CUDA device (``gpu`` marker, skipped here), K14 is its twin bit for
  bit in every column of ``cand``, in ``count``, ``overflow`` and the
  boxes: two levels at the ``pallas2.orbit`` settings (16x32 tiles, 64
  candidates, groups of 32, 24 groups) on the published 800,130-triangle
  scene at three poses of the orbit script; flat at 1, 64, 128 and every
  cluster (with tiles that see nothing and tiles that see fewer clusters
  than asked); lists longer than the CTA (128x256 tiles); sub-tile
  ordering (4, 16); a cluster count that is not a multiple of the group
  size; group overflow; the published scene at leaf size 32, whose 32,768
  clusters take levels of more than 16,384 positions, sorted in global
  scratch (flat, and two levels with many groups or many members). The
  captured "pallas2" frame with ``escalate_all`` is the eager one bit for
  bit, and the counter reads K14's launches in the capture and none in a
  replay.

On the card (no JAX there)::

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_cull_kernel.py
"""

import numpy as np
import pytest
import torch

import cpp_cuda_raytracer_dev_torch as P
from cpp_cuda_raytracer_dev_torch.accel import traverse as tr
from cpp_cuda_raytracer_dev_torch.models import renderer
from cpp_cuda_raytracer_dev_torch.models.animation import apply_key
from cpp_cuda_raytracer_dev_torch.models.camera import set_up_frame
from cpp_cuda_raytracer_dev_torch.ops import vecmath
from cpp_cuda_raytracer_dev_torch.ops.cuda import tile_intersect as ti
from cpp_cuda_raytracer_dev_torch.ops.quaternion import from_axis_angle
from cpp_cuda_raytracer_dev_torch.utils.graphs import GraphCache
from cpp_cuda_raytracer_dev_torch.utils.procgen import (dragon_class_mesh,
                                                        uv_sphere)

# the pallas2.orbit cell's settings (benchmark/configs/dragon800k-pallas2.json)
CELL = P.RenderConfig(method="pallas2", leaf_size=128, tile_h=16, tile_w=32,
                      max_candidates=64, group_size=32, max_groups=24,
                      escalate_tiles=64, escalate_factor=4,
                      escalate_all=True)
RES_W, RES_H = 960, 540
# ticks of the orbit script's keys (W30 R20 Q15 T40 ...) held in turn
POSES = {"start": (), "dolly-orbit": (("W", 30), ("R", 20)),
         "strafe-back": (("W", 30), ("R", 20), ("Q", 15), ("T", 40))}
OUTS = ("cand", "count", "overflow", "boxes")


def _small(device="cpu"):
    """A posed, rough 3,200-triangle sphere at 64x30 in 8x32 tiles,
    32-triangle clusters: (origin, tiles, accel)."""
    tv = uv_sphere(40, 40, roughness=0.03)
    tris = P.Triangles.from_vertices(np.roll(tv, -tv.shape[0] // 2, axis=0),
                                     device=device)
    pose = P.Pose(from_axis_angle([0.3, 1.0, 0.1], 0.6, device=device),
                  torch.tensor([0.15, -0.1, 0.2], device=device))
    cam = P.Camera.create(64, 30, pos=[1.8, 0.3, 1.6],
                          look_at=[0.15, -0.1, 0.2], up=[0.0, 1.0, 0.0],
                          film_h=0.024, focal=0.055, device=device)
    frame = set_up_frame(cam, [pose], "pallas2").objects[0]
    tiles, _ = tr._tile_rays(frame.rays, 30, 64, 8, 32)
    accel = P.ClusterAccel.build(tris, leaf_size=32, cache=False)
    return frame.origin, tiles, accel


def _assert_same(got, want, what=""):
    assert len(got) == len(want)
    for name, x, y in zip(OUTS, got, want):
        assert x.dtype == y.dtype and x.shape == y.shape, (what, name)
        assert torch.equal(x, y), (what, name,
                                   int((x != y).sum()), x.numel())


def _twin(o, tiles, accel, th, tw, k, sh=0, sw=0, group=0, kg=0):
    if group:
        out = tr.cull_tiles_hier_reference(o, tiles, accel, th, tw, k, group,
                                           kg, sh, sw)
    else:
        out = tr.cull_tiles_reference(o, tiles, accel, th, tw, k, sh, sw)
    return (*out, tr._candidate_boxes(o, accel, out[0], out[1]))


def _k14(o, tiles, accel, th, tw, k, sh=0, sw=0, group=0, kg=0):
    if group:
        return tr.cull_tiles_hier(o, tiles, accel, th, tw, k, group, kg, sh,
                                  sw, boxes=True)
    return tr.cull_tiles(o, tiles, accel, th, tw, k, sh, sw, boxes=True)


@pytest.mark.parametrize("group,kg", [(0, 0), (8, 4)])
def test_cull_takes_the_twin_on_cpu(group, kg):
    o, tiles, accel = _small()
    before = ti.cluster_cull.launches
    got = _k14(o, tiles, accel, 8, 32, 12, 0, 0, group, kg)
    _assert_same(got, _twin(o, tiles, accel, 8, 32, 12, 0, 0, group, kg))
    assert (got[2] > 0).any() and (got[1] > 0).any()
    # without boxes the three outputs alone, and the boxes apart alike
    three = (tr.cull_tiles_hier(o, tiles, accel, 8, 32, 12, group, kg)
             if group else tr.cull_tiles(o, tiles, accel, 8, 32, 12))
    assert len(three) == 3
    _assert_same(three, got[:3])
    assert torch.equal(tr._candidate_boxes(o, accel, got[0], got[1]),
                       got[3])
    assert ti.cluster_cull.launches == before


def test_launchers_refuse_cpu_tensors():
    o, tiles, accel = _small()
    with pytest.raises(ValueError, match="CUDA"):
        ti.cluster_cull(o, tiles, tiles.mean(dim=1), accel.bounds_min,
                        accel.bounds_max, tr._corner_idx(8, 32), 12)


def test_twin_dot_products_are_the_cpu_sum():
    """`_dot3` sums in the order K14 repeats; on the CPU it is
    `vecmath.dot` bit for bit, so the twin's CPU results did not move."""
    g = torch.Generator().manual_seed(7)
    a = torch.randn(300, 257, 3, generator=g) * 1e3
    b = torch.randn(300, 1, 3, generator=g)
    assert torch.equal(tr._dot3(a, b), vecmath.dot(a, b))
    assert torch.equal(tr._dot3(a, a), (a * a).sum(dim=-1))


# ---- on the card ----

def _gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def published():
    """The published scene on the card: (scene, camera, accel) and each
    pose's (origin, rays)."""
    dev = _gpu()
    tris = P.Triangles.from_vertices(dragon_class_mesh(800_000, 0),
                                     device=dev)
    assert tris.p1x.shape[0] == 800_130
    cam = P.Camera.create(RES_W, RES_H, pos=[0.0, 0.0, -3.0],
                          look_at=[0.0, 0.0, 0.0], up=[0.0, 1.0, 0.0],
                          film_h=0.024, focal=0.055, device=dev)
    scene = P.Scene([P.SceneObject(tris, P.Pose.identity(device=dev))],
                    P.PhongParams.reference(device=dev))
    accel = P.ClusterAccel.build(tris, leaf_size=CELL.leaf_size, cache=False)
    rays = {}
    for name, keys in POSES.items():
        s = scene
        for key, ticks in keys:
            for _ in range(ticks):
                s = apply_key(s, cam, key)
        frame = set_up_frame(cam, [s.objects[0].pose], "pallas2").objects[0]
        rays[name] = (frame.origin, frame.rays)
    return scene, cam, accel, rays


def _published_tiles(published, pose="start", sub=(0, 0)):
    _, _, accel, rays = published
    o, d = rays[pose]
    tiles, meta = tr._tile_rays(d, RES_H, RES_W, CELL.tile_h, CELL.tile_w,
                                *sub)
    return o, tiles, accel, meta[6], meta[7]


@pytest.mark.gpu
@pytest.mark.parametrize("pose", list(POSES))
def test_k14_two_levels_at_the_cell_settings_gpu(published, pose):
    o, tiles, accel, sh, sw = _published_tiles(published, pose)
    args = (o, tiles, accel, 16, 32, 64, sh, sw, 32, 24)
    before = ti.cluster_cull.launches
    got = _k14(*args)
    assert ti.cluster_cull.launches == before + 1
    want = _twin(*args)
    _assert_same(got, want, pose)
    assert tiles.shape[0] == 1020 and accel.num_clusters == 8192
    assert (want[2] > 0).any() and (want[1] == 0).any()


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 64, 128, "C"])
def test_k14_flat_gpu(published, k):
    o, tiles, accel, sh, sw = _published_tiles(published)
    k = accel.num_clusters if k == "C" else k
    args = (o, tiles, accel, 16, 32, k, sh, sw)
    got = _k14(*args)
    want = _twin(*args)
    _assert_same(got, want, k)
    count, overflow = want[1], want[2]
    assert (count == 0).any()                 # tiles that see nothing
    if k >= 128:                              # fewer visible than asked
        assert ((count > 0) & (count < k)).any()
    if k <= 64:
        assert (overflow > 0).any()
    if k == accel.num_clusters:
        assert (overflow == 0).all()


@pytest.mark.gpu
def test_k14_long_lists_gpu(published):
    """128x256 tiles see more than 256 clusters each: lists longer than
    the CTA's 256 threads, beside shorter ones."""
    _, _, accel, rays = published
    o, d = rays["start"]
    tiles, _ = tr._tile_rays(d, RES_H, RES_W, 128, 256)
    for k, group, kg in ((accel.num_clusters, 0, 0), (300, 0, 0),
                         (512, 32, 64)):
        args = (o, tiles, accel, 128, 256, k, 0, 0, group, kg)
        want = _twin(*args)
        _assert_same(_k14(*args), want, (k, group))
        assert (want[1] > 256).any() and (want[1] <= 256).any()


@pytest.mark.gpu
def test_k14_sub_tile_order_gpu(published):
    o, tiles, accel, sh, sw = _published_tiles(published, "dolly-orbit",
                                               (4, 16))
    assert (sh, sw) == (4, 16)
    for group, kg in ((0, 0), (32, 24)):
        args = (o, tiles, accel, 16, 32, 64, sh, sw, group, kg)
        _assert_same(_k14(*args), _twin(*args), group)


@pytest.mark.gpu
def test_k14_groups_that_do_not_divide_and_group_overflow_gpu(published):
    o, tiles, accel, sh, sw = _published_tiles(published, "strafe-back")
    assert accel.num_clusters % 24
    args = (o, tiles, accel, 16, 32, 64, sh, sw, 24, 8)
    _assert_same(_k14(*args), _twin(*args), "group 24")
    # k = kg x group: a tile overflows only through its groups
    args = (o, tiles, accel, 16, 32, 64, sh, sw, 32, 2)
    want = _twin(*args)
    _assert_same(_k14(*args), want, "kg 2")
    assert (want[2] >= 32).any()
    # the small scene: 100 clusters of 32 triangles, groups of 7
    so, stiles, saccel = _small("cuda")
    assert saccel.num_clusters % 7
    for k in (1, 7, 14):
        args = (so, stiles, saccel, 8, 32, k, 0, 0, 7, 2)
        _assert_same(_k14(*args), _twin(*args), ("small", k))


@pytest.fixture(scope="module")
def fine_accel(published):
    """The published scene's clusters at leaf size 32."""
    scene = published[0]
    return P.ClusterAccel.build(scene.objects[0].tris, leaf_size=32,
                                cache=False)


@pytest.mark.gpu
@pytest.mark.parametrize("k,group,kg,tile,every", [
    (64, 0, 0, (16, 32), 1), ("C", 0, 0, (16, 32), 4),
    (64, 32, 24, (16, 32), 1), (64, 1, 64, (16, 32), 1),
    (1024, 32, 600, (16, 32), 1), ("C", 0, 0, (128, 256), 1),
    (1024, 32, 600, (128, 256), 1)],
    ids=["flat-64", "flat-C", "cell-groups", "groups-of-1", "600-groups",
         "long-flat-C", "long-600-groups"])
def test_k14_more_than_16384_clusters_gpu(published, fine_accel, k, group,
                                          kg, tile, every):
    """32,768 clusters: a flat level, groups of one and 600 groups of 32
    are each more than 16,384 positions, which K14 sorts in its global
    scratch; groups of 32 at the cell's 24 stay in shared memory. Every
    fourth tile where 16x32 tiles list every cluster; 128x256 tiles see
    more than 256 clusters each."""
    _, _, _, rays = published
    o, d = rays["start"]
    tiles, meta = tr._tile_rays(d, RES_H, RES_W, *tile)
    tiles = tiles[::every].contiguous()
    accel = fine_accel
    c = accel.num_clusters
    assert c == 32768
    k = c if k == "C" else k
    in_scratch = ti._cull_launcher()[1](c, group, kg) > 0
    assert in_scratch == ((group, kg) != (32, 24))
    args = (o, tiles, accel, *tile, k, meta[6], meta[7], group, kg)
    before = ti.cluster_cull.launches
    got = _k14(*args)
    assert ti.cluster_cull.launches == before + 1
    want = _twin(*args)
    _assert_same(got, want, (k, group, kg, tile))
    if tile == (16, 32):
        assert (want[1] == 0).any()
        assert (want[2] > 0).any() == (k <= 64)
    else:
        assert (want[1] > 256).all() and (want[2] > 0).any() == (k < c)


@pytest.mark.gpu
def test_captured_exact_frame_is_the_eager_one_gpu(published, monkeypatch):
    """The cell's frame through `render_jit` (probe, warm-up, capture) and
    its replays, each bitwise `render`'s eager frame; the captures' K14
    launches move the counter, a replay's do not."""
    scene, cam, accel, _ = published
    monkeypatch.setattr(renderer, "FRAME_GRAPHS", GraphCache())
    scenes = [scene, apply_key(scene, cam, "R"), apply_key(scene, cam, "W")]
    moved, regrown = [], []
    for s in scenes:
        before = ti.cluster_cull.launches, renderer.FRAME_GRAPHS.regrown
        jit = P.render_jit(s, cam, CELL, (accel,))
        torch.cuda.synchronize()
        moved.append(ti.cluster_cull.launches - before[0])
        regrown.append(renderer.FRAME_GRAPHS.regrown - before[1])
        before = ti.cluster_cull.launches
        eager = P.render(s, cam, CELL, (accel,))
        assert ti.cluster_cull.launches == before + 2   # two passes
        for name in ("image", "radiance", "hit_t", "hit_tri", "hit_obj",
                     "normal", "point"):
            assert torch.equal(getattr(jit, name), getattr(eager, name)), name
    # the probe's two culls, then the warm-up's and the capture's two
    # passes at the first bucket and at each larger one; a replay none
    assert moved == [6 + 4 * regrown[0]] + [4 * n for n in regrown[1:]], \
        (moved, regrown)
