"""The port's scatter-min raster path (``accel/raster.py``,
``method="raster"``) against the JAX package's ``intersect_raster`` and the
port's own oracle.

Inputs: procgen meshes made from numpy seeds (a rough 5,000-triangle
sphere and a 20,000-triangle dragon-class mesh) at 96x64, from three
cameras each (front, oblique, close-up). Bars:
- hit ids equal to JAX's on every pixel and t within rtol 2e-6 (the same
  affine MT in another rounding: XLA on the CPU fuses multiply-adds, as in
  tests/test_torch_cluster.py's "grid" bar; measured up to 1.3e-6);
  the stats' ``ovf_tris`` and ``pairs`` equal JAX's;
- ids equal to the port's ``fixed`` oracle on >= 99.9% of pixels (the
  bar of tests/test_raster.py is 99.5%), t at rtol 3e-4 where they agree;
- an exact tie (two coplanar copies of one triangle) goes to the lowest id
  (tests/test_raster.py:103);
- a close-up whose dense list is larger than JAX's escalated capacity
  (4 x ``raster_ovf_cap``): JAX drops geometry and says so
  (``overflow`` > 0), the port sizes the list from the live count, drops
  nothing (``overflow`` 0) and equals the oracle.
"""

import dataclasses

import numpy as np
import pytest
import torch

import cpp_cuda_raytracer_dev_tpu as J
from cpp_cuda_raytracer_dev_tpu.accel.raster import \
    intersect_raster as jraster
from cpp_cuda_raytracer_dev_torch import (Camera, RenderConfig, Scene,
                                          SceneObject, Triangles, render)
from cpp_cuda_raytracer_dev_torch.accel.raster import intersect_raster
from cpp_cuda_raytracer_dev_torch.utils.procgen import (dragon_class_mesh,
                                                        uv_sphere)

RES_W, RES_H = 96, 64
MESHES = {"sphere": lambda: uv_sphere(50, 50, roughness=0.03),
          "dragon": lambda: dragon_class_mesh(20_000, seed=1)}
VIEWS = {"front": [0.1, 0.3, -3.0], "oblique": [2.0, 1.2, -2.0],
         "close": [0.1, 0.2, -1.3]}


def _both(tv, pos, res=(RES_W, RES_H), **kw):
    cam_kw = dict(pos=pos, look_at=[0.0, 0.0, 0.0], up=[0.0, 1.0, 0.0],
                  film_h=0.024, focal=0.055)
    jt = J.Triangles.from_vertices(tv)
    jc = J.Camera.create(*res, **cam_kw)
    jh, js = jraster(jc.pos, jc.ray_directions(), jt, jc.projection(),
                     J.RenderConfig(method="raster", with_stats=True, **kw),
                     res[1], res[0])
    pt = Triangles.from_vertices(tv, device="cpu")
    pc = Camera.create(*res, device="cpu", **cam_kw)
    with torch.no_grad():
        ph, ps = intersect_raster(pc.pos, pc.ray_directions(), pt,
                                  pc.projection(), RenderConfig(
                                      method="raster", with_stats=True, **kw),
                                  res[1], res[0])
    ref = render(Scene([SceneObject(pt)]), pc,
                 RenderConfig(method="fixed", chunk=1024))
    return (jh, {k: int(v) for k, v in js.items()}, ph, ps,
            ref.hit_tri.reshape(-1).numpy(), ref.hit_t.reshape(-1).numpy())


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("view", sorted(VIEWS))
def test_raster_matches_jax_and_the_oracle(mesh, view):
    jh, js, ph, ps, rtri, rt = _both(MESHES[mesh](), VIEWS[view])
    ptri, pt = ph.tri.numpy(), ph.t.numpy()
    assert (ptri >= 0).mean() > 0.05
    np.testing.assert_array_equal(ptri, np.asarray(jh.tri))
    np.testing.assert_array_equal(ph.obj.numpy(), np.asarray(jh.obj))
    np.testing.assert_allclose(pt, np.asarray(jh.t), rtol=2e-6)
    assert ps["ovf_tris"] == js["ovf_tris"] and ps["pairs"] == js["pairs"]
    assert ps["overflow"] == 0
    same = ptri == rtri
    assert same.mean() >= 0.999, same.mean()
    np.testing.assert_allclose(pt[same], rt[same], rtol=3e-4, atol=1e-4)


def test_raster_tie_break_lowest_id():
    quad = np.array([
        [[-1.0, -1.0, 2.0], [3.0, -1.0, 2.0], [-1.0, 3.0, 2.0]],
        [[-1.0, -1.0, 2.0], [3.0, -1.0, 2.0], [-1.0, 3.0, 2.0]],
    ], np.float32)
    tris = Triangles.from_vertices(quad, device="cpu")
    cam = Camera.create(32, 32, pos=[0.0, 0.0, 0.0], look_at=[0.0, 0.0, 1.0],
                        up=[0, 1, 0], film_h=0.024, focal=0.055,
                        device="cpu")
    with torch.no_grad():
        hit = intersect_raster(cam.pos, cam.ray_directions(), tris,
                               cam.projection(),
                               RenderConfig(method="raster"), 32, 32)
    tri = hit.tri.numpy()
    assert (tri >= 0).any()
    assert (tri[tri >= 0] == 0).all(), "ties must break to the lowest id"


def test_raster_closeup_drops_nothing():
    """raster_ovf_cap 16: JAX's dense list holds 64 triangles after its
    escalation and drops the rest (counted); the port holds them all."""
    tv = uv_sphere(50, 50, roughness=0.03)
    jh, js, ph, ps, rtri, _ = _both(tv, [0.05, 0.1, -1.15],
                                    raster_ovf_cap=16)
    assert js["ovf_tris"] == ps["ovf_tris"] > 64
    assert js["overflow"] > 0 and ps["overflow"] == 0
    assert (rtri >= 0).mean() > 0.3
    np.testing.assert_array_equal(ph.tri.numpy(), rtri)
    assert (np.asarray(jh.tri) != rtri).any(), "JAX should drop geometry"


def test_render_method_raster():
    """Through `render`: the projection reaches the raster path and its
    frame equals the oracle's; a band Projection (row0) gives the band's
    rows of the frame."""
    tv = uv_sphere(30, 30, roughness=0.03)
    tris = Triangles.from_vertices(tv, device="cpu")
    scene = Scene([SceneObject(tris)])
    cam = Camera.create(64, 40, pos=[0.1, 0.3, -3.0], look_at=[0, 0, 0],
                        up=[0, 1, 0], device="cpu")
    out = render(scene, cam, RenderConfig(method="raster"))
    ref = render(scene, cam, RenderConfig(method="fixed", chunk=1024))
    assert (out.hit_tri == ref.hit_tri).float().mean() >= 0.999
    proj = dataclasses.replace(cam.projection(), row0=20)
    with torch.no_grad():
        band = intersect_raster(cam.pos, cam.ray_directions()[20 * 64:],
                                tris, proj, RenderConfig(method="raster"),
                                20, 64)
    np.testing.assert_array_equal(band.tri.reshape(20, 64).numpy(),
                                  out.hit_tri[20:].numpy())
