"""The reference's two-object scene on the port's bin path (its
WinMain.cpp:152-156: two posed instances of one mesh), on the CPU.

Two objects share one `Triangles` (a roughened sphere of 2,024
triangles), posed so that they interpenetrate, at 96x54:
- `render_jit`'s frame against the plain reference over posed objects
  (``benchmark/reference/objects.py``, plain PyTorch): every pixel's
  (object, triangle) the reference's nearest or a tie within rounding by
  the benchmark's check (``benchmark/harness/check.py``), and the t, image
  and radiance of the choice; both objects seen, some pixels decided
  across the objects;
- one all-leaves SGD step of the compiled step: the gradients of every
  leaf, the shared triangle leaves among them, against the reference's,
  which are the sum over the two instances;
- the bin tables' fill counter (`utils/profiling.py` `bin_fill`): each
  object's live entry count and the bucket the frame's tables share.
"""

import sys
from pathlib import Path

import pytest
import torch

import cpp_cuda_raytracer_dev_torch as P
from cpp_cuda_raytracer_dev_torch.accel.traverse import bin_object
from cpp_cuda_raytracer_dev_torch.models import renderer
from cpp_cuda_raytracer_dev_torch.ops.quaternion import from_axis_angle
from cpp_cuda_raytracer_dev_torch.parallel.render_pjit import (
    make_train_step_jit)
from cpp_cuda_raytracer_dev_torch.utils import profiling
from cpp_cuda_raytracer_dev_torch.utils.graphs import GraphCache
from cpp_cuda_raytracer_dev_torch.utils.procgen import dragon_class_mesh

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import check  # noqa: E402
from benchmark.reference import objects as ref  # noqa: E402
from benchmark.reference import render as ref_render  # noqa: E402

RES_W, RES_H = 96, 54
# the configuration dragon800k-duo-bin's poses and render settings
POSES = ((0.35, (-0.55, 0.0, 0.0)), (-0.5, (0.6, 0.1, 0.4)))
CONFIG = P.RenderConfig(method="bin", tile_h=16, tile_w=32, bin_chunk=512,
                        backface_cull=True)
TRI_FIELDS = ("p1x", "p1y", "p1z", "e1x", "e1y", "e1z", "e2x", "e2y", "e2z")
CAMERA_FIELDS = ("pos", "look_at", "up", "film_w", "film_h", "focal")
PHONG_FIELDS = ("light_pos", "light_color", "diffuse", "specular",
                "exponent")


def _scene(n_objects=2, device="cpu"):
    tris = P.Triangles.from_vertices(dragon_class_mesh(2000), device=device)
    objects = [P.SceneObject(tris, P.Pose(
        from_axis_angle([0.0, 1.0, 0.0], a, device=device),
        torch.tensor(t, dtype=torch.float32, device=device)))
        for a, t in POSES[:n_objects]]
    return P.Scene(objects, P.PhongParams.reference(device=device))


def _camera(device="cpu"):
    return P.Camera.create(RES_W, RES_H, pos=[0.0, 0.2, -4.0],
                           look_at=[0.0, 0.0, 0.0], up=[0.0, 1.0, 0.0],
                           film_h=0.024, focal=0.055, device=device)


def _reference_inputs(scene, camera):
    """The reference's (tris, [pose], camera, phong) over the port's own
    leaves, so that its gradients reach them."""
    t_ = scene.objects[0].tris
    tris = {"geom": torch.stack([getattr(t_, n) for n in TRI_FIELDS], 1),
            "color": t_.color}
    poses = [{"quat": o.pose.quat, "translation": o.pose.translation}
             for o in scene.objects]
    cam = {k: getattr(camera, k) for k in CAMERA_FIELDS}
    cam.update(res_w=camera.res_w, res_h=camera.res_h)
    phong = {k: getattr(scene.phong, k) for k in PHONG_FIELDS}
    return tris, poses, cam, phong


def _ids(obj, tri, n):
    obj, tri = obj.long(), tri.long()
    return torch.where(tri >= 0, obj * n + tri, -1)


@pytest.fixture
def frame_graphs(monkeypatch):
    cache = GraphCache()
    monkeypatch.setattr(renderer, "FRAME_GRAPHS", cache)
    return cache


def test_two_object_frame_matches_the_reference(frame_graphs):
    scene, cam = _scene(), _camera()
    out = P.render_jit(scene, cam, CONFIG)
    args = _reference_inputs(scene, cam)
    n = scene.objects[0].tris.num_triangles
    with torch.no_grad():
        want = ref.render_objects(*args, cull=True)
        chosen = ref.choice(*args, out.hit_obj.reshape(-1),
                            out.hit_tri.reshape(-1))
    prog = {"image": out.image.reshape(-1, 3),
            "radiance": out.radiance.reshape(-1, 3),
            "t": out.hit_t.reshape(-1),
            "tri": _ids(out.hit_obj.reshape(-1), out.hit_tri.reshape(-1), n)}
    num = check.frame_numbers(prog, dict(want, tri=_ids(want["obj"],
                                                        want["tri"], n)),
                              chosen)
    assert num["off"] == 0, num
    assert num["radiance_gap"] < 1e-5 and num["surface_gap"] < 1e-6, num
    # the same (object, triangle) on all but a few tied pixels, and there
    # the same t, image and radiance as the reference's
    same = prog["tri"] == _ids(want["obj"], want["tri"], n)
    assert int((~same).sum()) <= 3
    hit = same & (prog["tri"] >= 0)
    assert torch.allclose(prog["t"][hit], want["t"][hit], rtol=1e-5)
    assert torch.allclose(prog["radiance"][hit], want["radiance"][hit],
                          rtol=1e-4, atol=1e-5)
    assert (prog["image"][same].int() - want["image"][same].int()).abs() \
        .max() <= 1
    assert torch.equal(out.hit_obj.reshape(-1)[same],
                       want["obj"][same].to(torch.int32))
    # both objects are seen, and the nearer decides where both are hit
    objs = out.hit_obj.reshape(-1)
    assert int((objs == 0).sum()) > 300 and int((objs == 1).sum()) > 300
    with torch.no_grad():
        d = ref_render.rays(args[2])
        t0, _ = ref_render.nearest_hits(args[0], args[1][0], args[2], True, d)
        t1, _ = ref_render.nearest_hits(args[0], args[1][1], args[2], True, d)
    both = (t0 < ref_render.DRAW_DISTANCE) & (t1 < ref_render.DRAW_DISTANCE)
    assert int(both.sum()) > 100
    assert torch.equal(objs[both & same].long(),
                       (t1 < t0)[both & same].long())
    assert int((both & (t1 < t0)).sum()) > 20
    assert int((both & (t0 < t1)).sum()) > 20


def test_two_object_step_gradients_match_the_reference(frame_graphs):
    """One all-leaves SGD step of the compiled step: each leaf's gradient
    against the reference's; the shared triangle leaves get the sum of the
    two instances' gradients."""
    scene, cam = _scene(), _camera()
    with torch.no_grad():
        target = ref.render_objects(*_reference_inputs(scene, cam),
                                    cull=True)["radiance"]
    # the fit starts from a moved light and object 1 turned a little
    with torch.no_grad():
        scene.phong.light_pos.add_(torch.tensor([0.3, -0.2, 0.1]))
        q = scene.objects[1].pose.quat
        q.copy_(from_axis_angle([0.0, 1.0, 0.0], -0.47, device="cpu"))
    leaves = [*scene.parameters(), *cam.parameters()]
    for p in leaves:
        p.requires_grad_(True)
    ref_grad = _reference_grad(scene, cam, target)
    apart = _reference_grad(scene, cam, target, instances_apart=True)
    step = make_train_step_jit(torch.optim.SGD(leaves, lr=1e-4), CONFIG)
    step({"scene": scene, "camera": cam}, target.reshape(RES_H, RES_W, 3))
    named = dict(scene.named_parameters())
    named.update({f"camera.{k}": v for k, v in cam.named_parameters()})
    assert set(named) == set(ref_grad)
    norms = {k: float(g.norm()) for k, g in ref_grad.items()}
    median = sorted(norms.values())[len(norms) // 2]
    for k, g in ref_grad.items():
        gap = float((named[k].grad - g).norm()) / max(norms[k], median)
        assert gap < 1e-4, (k, gap)
    # the shared leaves' gradient is the sum of the two instances', up to
    # the order of the sums (index backward accumulates in any order)
    for k in named:
        if ".tris." in k:
            gap = float((apart[k] - ref_grad[k]).norm())
            assert gap <= 1e-5 * float(ref_grad[k].norm()), (k, gap)


def _reference_grad(scene, cam, target, instances_apart=False):
    """The reference's gradient of the loss by leaf name. With
    ``instances_apart`` each object gets its own copy of the triangle
    leaves, and a triangle leaf's gradient is the sum of the copies'."""
    tris, poses, camera, phong = _reference_inputs(scene, cam)
    named = dict(scene.named_parameters())
    named.update({f"camera.{k}": v for k, v in cam.named_parameters()})
    fields = (*TRI_FIELDS, "color")
    keys = [k for k in named if not (instances_apart and ".tris." in k)]
    copies = []
    if instances_apart:
        t_ = scene.objects[0].tris
        copies = [{n: getattr(t_, n).detach().clone().requires_grad_(True)
                   for n in fields} for _ in poses]
        tris = [{"geom": torch.stack([c[n] for n in TRI_FIELDS], 1),
                 "color": c["color"]} for c in copies]
    loss = ref.loss(tris, poses, camera, phong, True, target)
    grads = torch.autograd.grad(
        loss, [named[k] for k in keys] + [c[n] for c in copies
                                          for n in fields],
        allow_unused=True)
    out = {k: torch.zeros_like(named[k]) if g is None else g
           for k, g in zip(keys, grads)}
    for i, n in enumerate(fields):
        if copies:
            parts = grads[len(keys) + i], grads[len(keys) + len(fields) + i]
            # each instance adds a share of its own
            assert all(float(g.norm()) > 0 for g in parts), n
            out[f"objects.0.tris.{n}"] = parts[0] + parts[1]
    return out


def _live_counts(scene, cam):
    """Each object's live entry count, from its own uncaptured prepass."""
    with torch.no_grad():
        return [int(bin_object(obj.pose.inv_apply(cam.pos), obj.tris,
                               cam.projection().transformed(obj.pose),
                               CONFIG, RES_H, RES_W)[1].num_entries)
                for obj in scene.objects]


def test_bin_fill_reads_each_objects_live_count(frame_graphs):
    scene, cam = _scene(), _camera()
    P.render_jit(scene, cam, CONFIG)
    counts, capacity = profiling.bin_fill()
    want = _live_counts(scene, cam)
    assert counts == want and len(set(want)) == 2
    assert capacity == next(iter(frame_graphs.buckets.values()))
    assert max(want) <= capacity < 2 * max(want) or capacity == 512
    # a frame of one object records one count, its own largest: nothing
    # is launched for it
    one = _scene(1)
    P.render_jit(one, cam, CONFIG)
    counts1, _ = profiling.bin_fill()
    assert counts1 == want[:1]
    budget = frame_graphs.tables[frame_graphs.last]
    assert budget.live is budget.counts[0]
    # a frame with no bin tables reads nothing
    P.render_jit(one, cam, P.RenderConfig(method="brute"))
    assert profiling.bin_fill() is None


@pytest.mark.gpu
def test_two_object_replays_and_their_fill_on_gpu(frame_graphs):
    """On the card: the two-object frame captured once and replayed at two
    poses of object 0, each replay bitwise `render`'s frame, and the fill
    counter reads each replay's own live counts (the graph's outputs,
    which every replay rewrites)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    dev = torch.device("cuda", 0)
    scene, cam = _scene(device=dev), _camera(device=dev)
    seen = []
    for angle in (0.35, 0.9, 0.35):
        with torch.no_grad():
            scene.objects[0].pose.quat.copy_(from_axis_angle(
                [0.0, 1.0, 0.0], angle, device=dev))
        got = P.render_jit(scene, cam, CONFIG)
        want = P.render(scene, cam, CONFIG)
        for f in ("image", "radiance", "hit_t", "hit_tri", "hit_obj",
                  "normal", "point"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        counts, capacity = profiling.bin_fill()
        assert counts == _live_counts(scene, cam)
        assert capacity == next(iter(frame_graphs.buckets.values()))
        seen.append(counts)
    assert frame_graphs.captures == 1 and frame_graphs.regrown == 0
    assert seen[0] == seen[2] != seen[1]
