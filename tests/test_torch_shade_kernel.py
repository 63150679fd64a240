"""Serving shading and composition, kernel K10 (``ops/cuda/shade.py``).

On the CPU:
- ``models/shading.py`` `shade_compose` (the device choice, which runs the
  plain version ``shade_compose_reference`` for CPU tensors and launches
  no kernel) gives bitwise the outputs of
  the unsplit code it was cut from, ``shade_hits`` then
  ``compose_framebuffer`` (image, radiance, normal, point and the hits),
  for two posed objects sharing one ``Triangles`` in float32, a float64
  frame, more objects than one launch serves, and rays whose recomputed MT
  rejects the hit (an epsilon edge), where t falls back to the traversal's;
- `render` of two posed objects against the JAX package's on the same
  numpy inputs, with the tolerances of tests/test_torch_render.py (ids
  equal on >= 99.9% of pixels, every mismatch an exact-t tie at rtol 1e-5;
  hit_t at rtol 1e-5; radiance at rtol 1e-4, atol 1e-5 where the ids agree;
  the image within 1);
- `shade_and_compose` takes the differentiable version with autograd on
  and an input that requires grad (``models/shade_grad.py``, whose own
  tests are tests/test_torch_shade_grad.py), the device choice otherwise,
  and the wrapper refuses operands the kernel does not take and CPU
  tensors.

On the card (marked ``gpu``; they skip here): K10 bitwise its plain version
on the same cases (float32 and float64, 1, 2 and 9 objects, the epsilon
edge, a frame of misses), and on the differentiable path one launch of
K10 forward and one of K12 backward:
    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_shade_kernel.py
"""

import math

import numpy as np
import pytest
import torch

from cpp_cuda_raytracer_dev_torch import (Camera, Pose, RenderConfig, Scene,
                                          SceneObject, Triangles, render)
from cpp_cuda_raytracer_dev_torch.models import shading
from cpp_cuda_raytracer_dev_torch.models.renderer import (shade_and_compose,
                                                          trace_rays)
from cpp_cuda_raytracer_dev_torch.models.shading import (
    shade_compose_reference, shade_hits)
from cpp_cuda_raytracer_dev_torch.ops.cuda import shade as k10
from cpp_cuda_raytracer_dev_torch.ops.intersect import Hit
from cpp_cuda_raytracer_dev_torch.ops.quaternion import from_axis_angle
from cpp_cuda_raytracer_dev_torch.ops.shade import compose_framebuffer
from cpp_cuda_raytracer_dev_torch.utils.procgen import uv_sphere

RES_W, RES_H = 96, 64
OUT = ("image", "radiance", "hit_t", "hit_tri", "hit_obj", "normal", "point")
# name: (objects, dtype, method)
CASES = {"one object": (1, torch.float32, "bin"),
         "two posed objects": (2, torch.float32, "bin"),
         "nine objects": (9, torch.float32, "fixed"),
         "float64": (1, torch.float64, "fixed"),
         "float64 two objects": (2, torch.float64, "fixed"),
         "misses only": (1, torch.float32, "fixed")}


def _world(case, device):
    """(scene, camera, config, origin, rays, hit) of a case: the objects
    share one Triangles (random colours from seed 0), each posed."""
    n, dtype, method = CASES[case]
    tv = uv_sphere(24, 24, roughness=0.03)
    color = np.random.default_rng(0).uniform(0.1, 1.0, (tv.shape[0], 3))
    tris = Triangles.from_vertices(tv, device=device, color=color,
                                   dtype=dtype)
    objs = []
    for i in range(n):
        x = 0.0 if n == 1 else -1.2 + 2.4 * i / (n - 1)
        quat = from_axis_angle([0.3, 1.0, 0.1], 0.4 * i + 0.2,
                               device=device).to(dtype)
        objs.append(SceneObject(tris, Pose(quat, torch.tensor(
            [x, 0.1 * i, 0.2 * (i % 2)], dtype=dtype, device=device))))
    scene = Scene(objs)
    look = [0.0, 0.0, -9.0] if case == "misses only" else [0.0, 0.0, 0.0]
    cam = Camera.create(RES_W, RES_H, pos=[0.1, 0.3, -2.0 - n],
                        look_at=look, up=[0.0, 1.0, 0.0], film_h=0.024,
                        focal=0.055, device=device, dtype=dtype)
    config = RenderConfig(method=method, tile_h=16, tile_w=32, bin_chunk=128,
                          chunk=512)
    with torch.no_grad():
        rmd = cam.ray_directions()
        proj = cam.projection() if method == "bin" else None
        hit = trace_rays(scene, cam.pos, rmd, config, None, RES_H, RES_W,
                         proj)
    return scene, cam, config, cam.pos, rmd, hit


def _edge_hit(hit):
    """The hits moved to triangle 0 of their object, which their rays miss:
    the recomputed MT rejects them and t falls back to the hit's."""
    return Hit(t=hit.t * 1.25, tri=torch.where(hit.tri >= 0, 0, -1).to(
        torch.int32), obj=hit.obj)


def _unsplit(scene, origin, rmd, hit, config):
    radiance, normal, point, mask = shade_hits(scene, origin, rmd, hit,
                                               config)
    return dict(image=compose_framebuffer(radiance, mask,
                                          config.background_rgb),
                radiance=torch.where(mask[..., None], radiance, 0.0),
                hit_t=hit.t, hit_tri=hit.tri, hit_obj=hit.obj, normal=normal,
                point=point)


@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_is_the_unsplit_shading(case, edge):
    scene, cam, config, origin, rmd, hit = _world(case, "cpu")
    if edge:
        hit = _edge_hit(hit)
    before = k10.shade_compose.launches
    with torch.no_grad():
        got = shading.shade_compose(scene, origin, rmd, hit, config)
        ref = _unsplit(scene, origin, rmd, hit, config)
    assert k10.shade_compose.launches == before      # no kernel launched
    for f in OUT:
        assert got[f].dtype == ref[f].dtype and torch.equal(got[f],
                                                            ref[f]), f
    hits = hit.tri >= 0
    if case == "misses only":
        assert not hits.any()
        assert (got["image"] == torch.tensor([240, 130, 0],
                                             dtype=torch.uint8)).all()
    else:
        assert hits.float().mean() > 0.2
        if CASES[case][0] > 1:
            assert len(torch.unique(hit.obj[hits])) == CASES[case][0]
    if edge and hits.any():
        # t is the hit's: the point lies at origin + t d (plain roundings)
        p = got["point"][hits]
        d, t = rmd[hits], hit.t[hits]
        for ax in range(3):
            assert torch.equal(p[:, ax], origin[ax] + t * d[:, ax])


def test_shading_dispatch_by_autograd():
    """Autograd on: the differentiable version (gradients reach the Phong
    parameters); off: the wrapper; bitwise the same outputs."""
    scene, cam, config, origin, rmd, hit = _world("two posed objects", "cpu")
    scene.phong.requires_grad_(True)
    out = shade_and_compose(scene, origin, rmd, hit, config)
    out["radiance"].sum().backward()
    assert scene.phong.diffuse.grad is not None
    with torch.no_grad():
        off = shade_and_compose(scene, origin, rmd, hit, config)
    for f in OUT:
        assert torch.equal(out[f].detach(), off[f]), f
    assert torch.equal(off["image"], shade_compose_reference(
        scene, origin, rmd, hit, config)["image"])


def test_shading_dispatch_without_grad_inputs(monkeypatch):
    """Autograd on but no input that requires grad: the device choice, as
    with autograd off."""
    from cpp_cuda_raytracer_dev_torch.models import renderer
    scene, cam, config, origin, rmd, hit = _world("two posed objects", "cpu")
    scene.requires_grad_(False)
    calls = []

    def spy(*args):
        calls.append(1)
        return shading.shade_compose(*args)
    monkeypatch.setattr(renderer, "shade_compose", spy)
    assert torch.is_grad_enabled()
    out = shade_and_compose(scene, origin, rmd, hit, config)
    assert calls == [1] and not out["radiance"].requires_grad
    scene.phong.exponent.requires_grad_(True)
    shade_and_compose(scene, origin, rmd, hit, config)
    assert calls == [1]


def test_render_two_objects_matches_jax():
    import jax
    import jax.numpy as jnp

    import cpp_cuda_raytracer_dev_tpu as J
    from cpp_cuda_raytracer_dev_tpu.ops.quaternion import Pose as JPose
    from cpp_cuda_raytracer_dev_tpu.ops.quaternion import \
        from_axis_angle as jaxis
    from cpp_cuda_raytracer_dev_torch.utils.convert import (camera_from_numpy,
                                                            path_dict,
                                                            scene_from_numpy)

    tv = uv_sphere(24, 24, roughness=0.03)
    color = np.random.default_rng(0).uniform(0.1, 1.0, (tv.shape[0], 3))
    jt = J.Triangles.from_vertices(tv, color.astype(np.float32))
    jscene = J.Scene.create([
        J.SceneObject.create(jt, JPose(quat=jaxis(jnp.array([0.0, 1.0, 0.0]),
                                                  0.3),
                                       translation=jnp.array([-0.6, 0.0,
                                                              0.0]))),
        J.SceneObject.create(jt, JPose(quat=jaxis(jnp.array([1.0, 0.0, 0.0]),
                                                  -0.5),
                                       translation=jnp.array([0.7, 0.1,
                                                              0.3])))])
    jcam = J.Camera.create(RES_W, RES_H, pos=[0.1, 0.3, -3.5],
                           look_at=[0.0, 0.0, 0.0], up=[0.0, 1.0, 0.0],
                           film_h=0.024, focal=0.055)
    flat = jax.tree_util.tree_flatten_with_path
    pscene = scene_from_numpy(path_dict(flat(jscene)[0]), "cpu")
    pcam = camera_from_numpy({**path_dict(flat(jcam)[0]), "res_w": RES_W,
                              "res_h": RES_H}, "cpu")
    kw = dict(method="bin", bin_chunk=128)
    jo = J.render(jscene, jcam, J.RenderConfig(**kw))
    po = render(pscene, pcam, RenderConfig(**kw))
    jtri, ptri = np.asarray(jo.hit_tri), po.hit_tri.numpy()
    same = (ptri == jtri) & (po.hit_obj.numpy() == np.asarray(jo.hit_obj))
    assert (ptri >= 0).mean() > 0.3 and same.mean() >= 0.999
    assert len(np.unique(po.hit_obj.numpy())) == 3     # both objects, misses
    np.testing.assert_allclose(po.hit_t.numpy(), np.asarray(jo.hit_t),
                               rtol=1e-5)
    np.testing.assert_allclose(po.radiance.numpy()[same],
                               np.asarray(jo.radiance)[same], rtol=1e-4,
                               atol=1e-5)
    for f in ("normal", "point"):
        np.testing.assert_allclose(getattr(po, f).numpy()[same],
                                   np.asarray(getattr(jo, f))[same],
                                   rtol=1e-4, atol=1e-5)
    diff = np.abs(po.image.numpy().astype(int)
                  - np.asarray(jo.image).astype(int))
    assert diff[same].max() <= 1


def test_wrapper_rejects_bad_operands():
    scene, cam, config, origin, rmd, hit = _world("one object", "cpu")
    with pytest.raises(ValueError, match="no shade_compose kernel for cpu"):
        k10.shade_compose(scene, origin, rmd, hit, config)
    with pytest.raises(TypeError, match="like the rays"):
        k10.shade_compose(scene, origin, rmd.double(),
                          Hit(hit.t.double(), hit.tri, hit.obj), config)
    with pytest.raises(ValueError, match="hit.tri"):
        k10.shade_compose(scene, origin, rmd, Hit(hit.t, hit.tri.long(),
                                                  hit.obj), config)
    with pytest.raises(ValueError, match="rmd"):
        k10.shade_compose(scene, origin, rmd[:, :2], hit, config)
    with pytest.raises(ValueError, match="origin"):
        k10.shade_compose(scene, origin[:2], rmd, hit, config)
    with pytest.raises(ValueError, match="hit.t"):
        k10.shade_compose(scene, origin, rmd, Hit(hit.t[1:], hit.tri,
                                                  hit.obj), config)
    pose = scene.objects[0].pose
    with torch.no_grad():
        pose.quat.data = pose.quat.data.double()
    with pytest.raises(TypeError, match="pose"):
        k10.shade_compose(scene, origin, rmd, hit, config)


@pytest.mark.gpu
@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_plain_version_on_gpu(case, edge):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    scene, cam, config, origin, rmd, hit = _world(case, "cuda")
    if edge:
        hit = _edge_hit(hit)
    n_obj = CASES[case][0]
    before = k10.shade_compose.launches
    with torch.no_grad():
        got = k10.shade_compose(scene, origin, rmd, hit, config)
        torch.cuda.synchronize()
        ref = shade_compose_reference(scene, origin, rmd, hit, config)
    assert k10.shade_compose.launches == before + math.ceil(
        n_obj / k10.max_objects())
    for f in OUT:
        assert got[f].dtype == ref[f].dtype and torch.equal(got[f],
                                                            ref[f]), f


@pytest.mark.gpu
def test_autograd_launches_k10_and_k12_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    scene, cam, config, origin, rmd, hit = _world("two posed objects",
                                                  "cuda")
    scene.phong.requires_grad_(True)
    before = k10.shade_compose.launches, k10.shade_grad.launches
    out = shade_and_compose(scene, origin, rmd, hit, config)
    out["radiance"].sum().backward()
    assert (k10.shade_compose.launches, k10.shade_grad.launches) == (
        before[0] + 1, before[1] + 1)
    assert scene.phong.diffuse.grad is not None
    with torch.no_grad():
        off = shade_and_compose(scene, origin, rmd, hit, config)
    assert (k10.shade_compose.launches, k10.shade_grad.launches) == (
        before[0] + 2, before[1] + 1)
    for f in OUT:
        assert torch.equal(out[f].detach(), off[f]), f
