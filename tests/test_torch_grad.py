"""Gradients of the port's differentiable frame (`render_differentiable`):
finite differences, as ``tests/test_grad.py`` checks the JAX package, and
the port's autograd against ``jax.grad`` leaf by leaf.

Finite differences: the cases and tolerances of ``tests/test_grad.py``
(``simple_tris`` at 12x12, ``method="fixed"``): light position and diffuse
at relative 2e-2; translation and camera position at 1e-2 on a loss masked
to silhouette-free pixels (hit selection carries no gradient, so only
there is the fixed-topology gradient the derivative); triangle leaves at 5%;
the quaternion's gradient finite and not 0. The port stores the triangle
leaves p1, e1, e2 (not vertices), so the vertex checks perturb those.

Against ``jax.grad(loss, argnums=(0, 1))`` with the bench's weighted loss
``mean(radiance * linspace(0.3, 1.7))``, over every scene and camera leaf:
rtol 1e-4 and atol 1e-5 * max|g| per leaf. JAX on the CPU sums the gather's
VJP through ``_bwd_cumsum``, a difference of running sums, and its XLA
fuses multiply-adds; the port sums each triangle's rows in sorted order and
rounds every product.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpp_cuda_raytracer_dev_tpu as J
from cpp_cuda_raytracer_dev_tpu.ops.quaternion import Pose as JPose
from cpp_cuda_raytracer_dev_tpu.ops.quaternion import \
    from_axis_angle as jaxis_angle
from cpp_cuda_raytracer_dev_torch import (Camera, PhongParams, Pose,
                                          RenderConfig, Scene, SceneObject,
                                          Triangles, render,
                                          render_differentiable)
from cpp_cuda_raytracer_dev_torch.ops.quaternion import from_axis_angle
from cpp_cuda_raytracer_dev_torch.utils.convert import (camera_from_numpy,
                                                        params_to_numpy,
                                                        path_dict,
                                                        scene_from_numpy)
from cpp_cuda_raytracer_dev_torch.utils.procgen import uv_sphere

CFG = RenderConfig(method="fixed", chunk=8)
RES = 12


def _params(simple_tris):
    return {
        "verts": simple_tris.astype(np.float32),
        "quat": from_axis_angle([0.0, 1.0, 0.0], 0.1,
                                device="cpu").numpy(),
        "trans": np.array([0.02, -0.01, 0.0], np.float32),
        "light_pos": np.array([2.0, 2.0, 2.0], np.float32),
        "diffuse": np.float32(0.6),
        "cam_pos": np.array([0.0, 0.0, -1.0], np.float32),
    }


def _build(p, tri_leaf=None):
    """Scene and camera from numpy parameters; ``tri_leaf`` = (name, value)
    replaces one triangle leaf."""
    tris = Triangles.from_vertices(p["verts"], device="cpu")
    if tri_leaf is not None:
        getattr(tris, tri_leaf[0]).data = torch.tensor(tri_leaf[1])

    def t(x):
        return torch.tensor(np.asarray(x, np.float32))
    phong = PhongParams(t(p["light_pos"]), torch.ones(3), t(p["diffuse"]),
                        torch.tensor(0.3), torch.tensor(5.0))
    scene = Scene([SceneObject(tris, Pose(t(p["quat"]), t(p["trans"])))],
                  phong)
    cam = Camera.create(RES, RES, pos=t(p["cam_pos"]), look_at=[0.0, 0.0, 0.0],
                        up=[0.0, 1.0, 0.0], film_h=0.024, focal=0.01,
                        device="cpu")
    return scene, cam


def _weighted(rad, mask):
    w = torch.linspace(0.3, 1.7, RES * RES * 3).reshape(RES, RES, 3)
    rad = rad * w
    if mask is not None:
        rad = rad * mask[..., None]
    return rad.mean()


def _loss_value(p, mask=None, tri_leaf=None):
    scene, cam = _build(p, tri_leaf)
    return float(_weighted(render(scene, cam, CFG).radiance, mask))


def _grads(p, mask=None):
    """{leaf: gradient} of the weighted loss, from autograd."""
    scene, cam = _build(p)
    cam.requires_grad_()
    _weighted(render_differentiable(scene, cam, CFG).radiance,
              mask).backward()
    obj = scene.objects[0]
    out = {"quat": obj.pose.quat.grad, "trans": obj.pose.translation.grad,
           "light_pos": scene.phong.light_pos.grad,
           "diffuse": scene.phong.diffuse.grad, "cam_pos": cam.pos.grad}
    out.update({f: getattr(obj.tris, f).grad for f in
                ("p1x", "p1y", "p1z", "e1x", "e1y", "e1z", "e2x", "e2y",
                 "e2z")})
    return {k: v.numpy().astype(np.float64) for k, v in out.items()}


def _interior_mask(p):
    scene, cam = _build(p)
    tri = render(scene, cam, CFG).hit_tri.numpy()
    ok = tri >= 0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            ok &= np.roll(np.roll(tri, dy, 0), dx, 1) == tri
    ok[0, :] = ok[-1, :] = False
    ok[:, 0] = ok[:, -1] = False
    return torch.tensor(ok.astype(np.float32))


def _fd(f, x, eps):
    flat = np.asarray(x, np.float64).ravel()
    g = np.zeros_like(flat)
    for i in range(flat.size):
        for s, sign in ((eps, 1.0), (-eps, -1.0)):
            q = flat.copy()
            q[i] += s
            g[i] += sign * f(q.reshape(np.shape(x)).astype(np.float32))
    return (g / (2 * eps)).reshape(np.shape(x))


@pytest.mark.parametrize("leaf,eps,tol,masked", [
    ("light_pos", 1e-3, 2e-2, False),
    ("diffuse", 1e-3, 2e-2, False),
    ("trans", 5e-4, 1e-2, True),
    ("cam_pos", 1e-4, 1e-2, True),
])
def test_grad_matches_fd(simple_tris, leaf, eps, tol, masked):
    p = _params(simple_tris)
    mask = _interior_mask(p) if masked else None
    grad = _grads(p, mask)[leaf]
    fd = _fd(lambda v: _loss_value({**p, leaf: v}, mask), p[leaf], eps)
    denom = np.maximum(np.abs(fd), np.max(np.abs(fd)) * 1e-2 + 1e-8)
    assert np.nanmax(np.abs(grad - fd) / denom) < tol, (leaf, grad, fd)


def test_grad_triangle_leaves_nonzero_and_fd(simple_tris):
    p = _params(simple_tris)
    grads = _grads(p)
    assert max(np.abs(grads[f]).max() for f in ("p1x", "e1y", "e2z")) > 0
    leaves = params_to_numpy(_build(p)[0].objects[0].tris)
    eps = 1e-4
    for name, i in (("p1x", 0), ("p1z", 0), ("e1y", 1), ("e2x", 1),
                    ("e2z", 0)):
        hi, lo = leaves[name].astype(np.float64), leaves[name].astype(
            np.float64)
        hi[i] += eps
        lo[i] -= eps
        fd = (_loss_value(p, tri_leaf=(name, hi.astype(np.float32)))
              - _loss_value(p, tri_leaf=(name, lo.astype(np.float32)))
              ) / (2 * eps)
        g = grads[name][i]
        assert abs(g - fd) <= 0.05 * max(abs(fd), abs(g), 1e-3), (name, i,
                                                                  g, fd)


def test_quaternion_grad_exists(simple_tris):
    g = _grads(_params(simple_tris))["quat"]
    assert np.isfinite(g).all() and np.abs(g).max() > 0


def _jax_case(method, roll=True):
    """A posed sphere. With ``roll`` its triangle list starts at the
    equator: every miss pixel gathers triangle 0, and the sphere's first
    triangles (at the pole) are degenerate, where the JAX package's
    gradient is NaN (see test_degenerate_triangle_0_gets_a_zero_gradient)."""
    if method == "fixed":
        tv, res, kw = uv_sphere(12, 12), (32, 24), dict(method="fixed",
                                                        chunk=256)
    else:
        tv, res, kw = (uv_sphere(50, 50, roughness=0.03), (96, 64),
                       dict(method="bin", bin_chunk=128))
    if roll:
        tv = np.roll(tv, -(tv.shape[0] // 2), axis=0)
    color = np.random.default_rng(0).uniform(0.1, 1.0, (tv.shape[0], 3))
    pose = JPose(quat=jaxis_angle(jnp.array([0.3, 1.0, 0.1]), 0.6),
                 translation=jnp.array([0.15, -0.1, 0.2]))
    jscene = J.Scene.create([J.SceneObject.create(
        J.Triangles.from_vertices(tv, color.astype(np.float32)), pose)])
    jcam = J.Camera.create(*res, pos=[0.1, 0.3, -3.0],
                           look_at=[0.0, 0.0, 0.0], up=[0.0, 1.0, 0.0],
                           film_h=0.024, focal=0.055)
    return jscene, jcam, res, kw


@pytest.mark.parametrize("method", ["fixed", "bin"])
def test_grad_matches_jax(method):
    jscene, jcam, (rw, rh), kw = _jax_case(method)
    w = np.linspace(0.3, 1.7, rw * rh * 3, dtype=np.float32).reshape(rh, rw,
                                                                      3)
    jcfg = J.RenderConfig(**kw)

    def jloss(s, c):
        return jnp.mean(J.render(s, c, jcfg).radiance * w)

    jg = jax.grad(jloss, argnums=(0, 1))(jscene, jcam)
    flat = jax.tree_util.tree_flatten_with_path
    want = {**path_dict(flat(jg[0])[0]),
            **{"cam." + k: v for k, v in path_dict(flat(jg[1])[0]).items()}}

    pscene = scene_from_numpy(path_dict(flat(jscene)[0]), "cpu")
    pcam = camera_from_numpy({**path_dict(flat(jcam)[0]), "res_w": rw,
                              "res_h": rh}, "cpu").requires_grad_()
    out = render_differentiable(pscene, pcam, RenderConfig(**kw))
    assert (out.hit_tri >= 0).float().mean() > 0.3
    torch.mean(out.radiance * torch.tensor(w)).backward()
    got = {**params_to_numpy(pscene, grad=True),
           **{"cam." + k: v
              for k, v in params_to_numpy(pcam, grad=True).items()}}
    assert sorted(got) == sorted(want)
    for k in want:
        j = np.asarray(want[k])
        assert got[k].shape == j.shape, k
        np.testing.assert_allclose(got[k], j, rtol=1e-4,
                                   atol=1e-5 * np.abs(j).max(), err_msg=k)
    assert np.abs(got["objects.0.tris.p1x"]).max() > 0


def test_degenerate_triangle_0_gets_a_zero_gradient():
    """Miss pixels gather triangle 0 with a zero cotangent. On a degenerate
    triangle 0 (|e1 x e2| = 0) the rsqrt of the normal's clamped length has
    an infinite derivative: JAX's ``maximum`` VJP multiplies 0 * inf into
    NaN (and its CPU cumsum backward spreads it to every later triangle),
    while PyTorch's ``clamp_min`` backward selects 0. No pixel sees the
    triangle, so 0 is its true gradient."""
    jscene, jcam, (rw, rh), kw = _jax_case("fixed", roll=False)
    flat = jax.tree_util.tree_flatten_with_path
    pscene = scene_from_numpy(path_dict(flat(jscene)[0]), "cpu")
    pcam = camera_from_numpy({**path_dict(flat(jcam)[0]), "res_w": rw,
                              "res_h": rh}, "cpu").requires_grad_()
    tris = pscene.objects[0].tris
    assert float(torch.linalg.cross(tris.e1[0], tris.e2[0]).detach()
                 .norm()) == 0.0
    out = render_differentiable(pscene, pcam, RenderConfig(**kw))
    assert bool((out.hit_tri != 0).all()) and bool((out.hit_tri < 0).any())
    out.radiance.mean().backward()
    for k, g in params_to_numpy(pscene, grad=True).items():
        assert np.isfinite(g).all(), k
    assert (params_to_numpy(tris, grad=True)["e1x"][0] == 0).all()
