"""The port's float64 path against the JAX package's under ``enable_x64``:
the three cases of tests/test_f64.py, each run in both packages.

- ``brute`` and ``fixed`` frames in float64 (``F64.fp`` threaded through
  `Triangles.from_vertices`, `Camera.create` and the default
  `PhongParams` / `Pose`): every float output float64; hit ids equal to
  JAX's float64 frame; t and radiance within 1e-12 relative (both compute
  in float64; XLA fuses multiply-adds the port rounds apart); the same bars
  as test_f64.py against the port's own float32 frame (ids on >= 98% of
  pixels, t at rtol 1e-5 where they agree).
- The analytic ray: |t - 3| <= 1e-12 in float64, no worse than float32,
  and equal to JAX's float64 t within 1e-15.
- ``jax.grad`` of the mean radiance with respect to the camera position in
  float64: the port's autograd gradient is float64, finite, and equal to
  JAX's within rtol 1e-9.
- The kernel methods and ``raster`` refuse float64 with a TypeError, and
  `utils/convert.py` keeps the dtype of the arrays it is given.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpp_cuda_raytracer_dev_tpu as J
from cpp_cuda_raytracer_dev_tpu.ops.intersect import mt_brute as jmt_brute
from cpp_cuda_raytracer_dev_torch import (Camera, RenderConfig, Scene,
                                          SceneObject, Triangles, render,
                                          render_differentiable)
from cpp_cuda_raytracer_dev_torch.ops.intersect import mt_brute
from cpp_cuda_raytracer_dev_torch.utils.convert import (camera_from_numpy,
                                                        path_dict,
                                                        scene_from_numpy)
from cpp_cuda_raytracer_dev_torch.utils.dtypes import F32, F64

CAM = dict(pos=[0.0, 0.0, -1.0], look_at=[0.0, 0.0, 0.0], up=[0.0, 1.0, 0.0],
           film_h=0.024, focal=0.01)


def _build(simple_tris, dtype):
    tris = Triangles.from_vertices(simple_tris, device="cpu", dtype=dtype)
    return Scene([SceneObject(tris)]), Camera.create(24, 24, device="cpu",
                                                     dtype=dtype, **CAM)


def _jbuild(simple_tris, dtype):
    tris = J.Triangles.from_vertices(simple_tris, dtype=dtype)
    return (J.Scene.create([J.SceneObject.create(tris)]),
            J.Camera.create(24, 24, dtype=dtype, **CAM))


@pytest.mark.parametrize("method", ["brute", "fixed"])
def test_f64_forward_matches_jax_and_f32_topology(simple_tris, method):
    scene64, cam64 = _build(simple_tris, F64.fp)
    assert all(p.dtype == torch.float64 for p in scene64.parameters())
    out64 = render(scene64, cam64, RenderConfig(method=method, chunk=2))
    for f in ("radiance", "hit_t", "normal", "point"):
        assert getattr(out64, f).dtype == torch.float64, f
    assert torch.isfinite(out64.radiance).all()
    with jax.enable_x64(True):
        js, jc = _jbuild(simple_tris, jnp.float64)
        jo = J.render(js, jc, J.RenderConfig(method=method, chunk=2))
        jtri, jt = np.asarray(jo.hit_tri), np.asarray(jo.hit_t)
        jrad = np.asarray(jo.radiance)
    assert jt.dtype == np.float64
    np.testing.assert_array_equal(out64.hit_tri.numpy(), jtri)
    np.testing.assert_allclose(out64.hit_t.numpy(), jt, rtol=1e-12)
    np.testing.assert_allclose(out64.radiance.numpy(), jrad, rtol=1e-12,
                               atol=1e-15)

    scene32, cam32 = _build(simple_tris, F32.fp)
    out32 = render(scene32, cam32, RenderConfig(method=method, chunk=2))
    assert out32.radiance.dtype == torch.float32
    same = out64.hit_tri.numpy() == out32.hit_tri.numpy()
    assert same.mean() >= 0.98
    np.testing.assert_allclose(out64.hit_t.numpy()[same],
                               out32.hit_t.numpy()[same], rtol=1e-5)


def test_f64_is_actually_more_precise():
    tv = np.array([[[-1, -1, 2], [1, -1, 2], [-1, 1, 2]]], np.float64)
    d = np.array([[0.0, 0.0, 1.0]])
    o = np.array([-0.1, -0.1, -1.0])
    with torch.no_grad():
        t64 = float(mt_brute(torch.tensor(o), torch.tensor(d),
                             Triangles.from_vertices(tv, device="cpu",
                                                     dtype=torch.float64),
                             chunk=1).t[0])
        t32 = float(mt_brute(torch.tensor(o, dtype=torch.float32),
                             torch.tensor(d, dtype=torch.float32),
                             Triangles.from_vertices(tv, device="cpu"),
                             chunk=1).t[0])
    with jax.enable_x64(True):
        jtris = J.Triangles.from_vertices(tv, dtype=jnp.float64)
        jt64 = float(jmt_brute(jnp.asarray(o), jnp.asarray(d), jtris,
                               chunk=1).t[0])
    assert abs(t64 - 3.0) <= 1e-12
    assert abs(t64 - 3.0) <= abs(t32 - 3.0) + 1e-12
    assert abs(t64 - jt64) <= 1e-15


def test_f64_gradients_match_jax(simple_tris):
    cfg = RenderConfig(method="fixed", chunk=2)
    scene, cam = _build(simple_tris, F64.fp)
    cam.pos.requires_grad_(True)
    render_differentiable(scene, cam, cfg).radiance.mean().backward()
    g = cam.pos.grad
    assert g.dtype == torch.float64 and torch.isfinite(g).all()
    with jax.enable_x64(True):
        js, jc = _jbuild(simple_tris, jnp.float64)

        def loss(pos):
            return jnp.mean(J.render(js, jc.replace(pos=pos),
                                     J.RenderConfig(method="fixed",
                                                    chunk=2)).radiance)
        jg = np.asarray(jax.grad(loss)(jc.pos))
    assert jg.dtype == np.float64
    np.testing.assert_allclose(g.numpy(), jg, rtol=1e-9,
                               atol=1e-12 * np.abs(jg).max())


@pytest.mark.parametrize("method", ["bin", "grid", "pallas", "pallas2",
                                    "raster"])
def test_kernel_methods_refuse_float64(simple_tris, method):
    scene, cam = _build(simple_tris, F64.fp)
    with pytest.raises(TypeError, match="float32 only"):
        render(scene, cam, RenderConfig(method=method), accel=(None,))


def test_convert_keeps_the_dtype(simple_tris):
    with jax.enable_x64(True):
        js, jc = _jbuild(simple_tris, jnp.float64)
        flat = jax.tree_util.tree_flatten_with_path
        scene = scene_from_numpy(path_dict(flat(js)[0]), "cpu")
        cam = camera_from_numpy({**path_dict(flat(jc)[0]), "res_w": 24,
                                 "res_h": 24}, "cpu")
    assert all(p.dtype == torch.float64 for p in scene.parameters())
    assert all(p.dtype == torch.float64 for p in cam.parameters())
    assert F64.precision_shift == 63 and F32.precision_shift == 31
