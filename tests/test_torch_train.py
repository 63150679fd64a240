"""The port's training step (`make_train_step`) against the JAX package's
``make_train_step(optax.sgd(lr), config, None)``: two steps from the same
scene and camera parameters toward the same target image.

``torch.optim.SGD(lr)`` without momentum is ``optax.sgd(lr)``: p - lr g.
Tolerances, per step and leaf by leaf:
- losses at rtol 1e-5;
- the gradient each step used (the port's ``.grad`` after the step against
  ``jax.grad`` of JAX's loss at the port's pre-step parameters) at rtol
  1e-4, as in tests/test_torch_grad.py (JAX on the CPU sums the gather's
  backward through a cumsum difference, the port in sorted order), with
  atol 1e-5 * max(|g|, |g_abs|) per leaf. g_abs is the port's gradient for
  the cotangent |dL/drad| instead of dL/drad: the MSE cotangent changes
  sign across pixels, so a leaf's gradient is a sum of terms of both signs,
  and float32 rounds it in proportion to the sum of their sizes, of which
  |g_abs| is a lower bound (for d/d specular it is 15 |g|);
- the step's change p_after - p_before against JAX's change at rtol 1e-4,
  atol 1e-5 * max|change| plus one float32 spacing of p_before: both round
  p - lr g to float32, and the two roundings may land one spacing apart;
- post-step parameters at rtol 1e-5 (atol 1e-7 for entries at 0).
lr g is about 1e-6 of most parameters, so only the first two checks can see
a wrong, partial or missing update of those leaves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import cpp_cuda_raytracer_dev_tpu as J
from cpp_cuda_raytracer_dev_tpu.ops.quaternion import Pose as JPose
from cpp_cuda_raytracer_dev_tpu.ops.quaternion import \
    from_axis_angle as jaxis_angle
from cpp_cuda_raytracer_dev_tpu.parallel.render_pjit import \
    make_loss_fn as jmake_loss_fn
from cpp_cuda_raytracer_dev_tpu.parallel.render_pjit import \
    make_train_step as jmake_train_step
from cpp_cuda_raytracer_dev_torch import (RenderConfig,
                                          render_differentiable)
from cpp_cuda_raytracer_dev_torch.parallel.render_pjit import (
    make_loss_fn, make_train_step)
from cpp_cuda_raytracer_dev_torch.utils.convert import (camera_from_numpy,
                                                        params_to_numpy,
                                                        path_dict,
                                                        scene_from_numpy)
from cpp_cuda_raytracer_dev_torch.utils.procgen import uv_sphere

RES_W, RES_H, LR = 32, 24, 1e-3
KW = dict(method="fixed", chunk=256)


def _jax_scene(angle):
    # start at the equator: triangle 0 is gathered by every miss pixel and
    # must not be the pole's degenerate one (tests/test_torch_grad.py)
    tv = np.roll(uv_sphere(12, 12), -72, axis=0)
    color = np.random.default_rng(0).uniform(0.1, 1.0, (tv.shape[0], 3))
    pose = JPose(quat=jaxis_angle(jnp.array([0.3, 1.0, 0.1]), angle),
                 translation=jnp.array([0.15, -0.1, 0.2]))
    return J.Scene.create([J.SceneObject.create(
        J.Triangles.from_vertices(tv, color.astype(np.float32)), pose)])


def _leaves(scene_tree, camera_tree):
    return {**path_dict(scene_tree), **{"cam." + k: v for k, v in
                                        path_dict(camera_tree).items()}}


def test_two_sgd_steps_match_jax():
    jcam = J.Camera.create(RES_W, RES_H, pos=[0.1, 0.3, -3.0],
                           look_at=[0.0, 0.0, 0.0], up=[0.0, 1.0, 0.0],
                           film_h=0.024, focal=0.055)
    target = np.asarray(J.render(_jax_scene(0.6), jcam,
                                 J.RenderConfig(**KW)).radiance)
    jparams = {"scene": _jax_scene(0.6 + np.radians(2.0)), "camera": jcam}

    flat = jax.tree_util.tree_flatten_with_path
    scene = scene_from_numpy(path_dict(flat(jparams["scene"])[0]), "cpu")
    camera = camera_from_numpy({**path_dict(flat(jcam)[0]), "res_w": RES_W,
                                "res_h": RES_H}, "cpu").requires_grad_()
    params = {"scene": scene, "camera": camera}
    opt = torch.optim.SGD([*scene.parameters(), *camera.parameters()], lr=LR)
    step = make_train_step(opt, RenderConfig(**KW))

    jopt = optax.sgd(LR)
    jstep = jax.jit(jmake_train_step(jopt, J.RenderConfig(**KW), None))
    jgrad = jax.jit(jax.grad(jmake_loss_fn(J.RenderConfig(**KW), None)))
    jstate = jopt.init(jparams)

    def jleaves(tree):
        return _leaves(flat(tree["scene"])[0], flat(tree["camera"])[0])

    def leaves(grad=False):
        return {**params_to_numpy(scene, grad=grad),
                **{"cam." + k: v for k, v in
                   params_to_numpy(camera, grad=grad).items()}}

    def as_jax(tree):          # the port's parameters in JAX's pytree
        d = {**params_to_numpy(scene), **params_to_numpy(camera)}
        return jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(tree),
            [jnp.array(d[k]) for k in path_dict(flat(tree)[0])])

    def abs_cotangent_grads(tgt):
        rad = render_differentiable(scene, camera, RenderConfig(**KW)).radiance
        ct = (2 * (rad - tgt) / rad.numel()).detach().abs()
        named = [*scene.named_parameters(),
                 *(("cam." + n, q) for n, q in camera.named_parameters())]
        gs = torch.autograd.grad((ct * rad).sum(), [q for _, q in named],
                                 allow_unused=True)
        return {n: np.abs(g.numpy()).max() if g is not None else 0.0
                for (n, _), g in zip(named, gs)}

    for _ in range(2):
        before = jleaves(jparams)
        g_abs = abs_cotangent_grads(torch.tensor(target))
        jg = jleaves(jgrad({"scene": as_jax(jparams["scene"]),
                            "camera": as_jax(jparams["camera"])},
                           jnp.asarray(target)))
        jparams, jstate, jloss = jstep(jparams, jstate, jnp.asarray(target))
        loss = step(params, torch.tensor(target))
        assert not loss.requires_grad
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        want, got, grads = jleaves(jparams), leaves(), leaves(grad=True)
        assert sorted(got) == sorted(want) == sorted(grads) == sorted(jg)
        for k, v in want.items():
            g = np.asarray(jg[k])
            np.testing.assert_allclose(
                grads[k], g, rtol=1e-4,
                atol=1e-5 * max(np.abs(g).max(), g_abs[k]), err_msg=k)
            p0 = np.asarray(before[k], np.float64)
            change = np.asarray(v, np.float64) - p0
            np.testing.assert_array_less(
                np.abs(got[k] - p0 - change),
                1e-4 * np.abs(change) + 1e-5 * np.abs(change).max()
                + np.spacing(np.abs(before[k]).astype(np.float32)),
                err_msg=k)
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-7,
                                       err_msg=k)
    assert float(loss) > 0


def test_loss_fn_is_the_mean_squared_error():
    scene = scene_from_numpy(path_dict(
        jax.tree_util.tree_flatten_with_path(_jax_scene(0.6))[0]), "cpu")
    jcam = J.Camera.create(RES_W, RES_H, pos=[0.1, 0.3, -3.0],
                           look_at=[0.0, 0.0, 0.0], up=[0.0, 1.0, 0.0])
    camera = camera_from_numpy({**path_dict(
        jax.tree_util.tree_flatten_with_path(jcam)[0]), "res_w": RES_W,
        "res_h": RES_H}, "cpu")
    loss = make_loss_fn(RenderConfig(**KW))(
        {"scene": scene, "camera": camera}, torch.zeros(RES_H, RES_W, 3))
    rad = J.render(_jax_scene(0.6), jcam, J.RenderConfig(**KW)).radiance
    np.testing.assert_allclose(float(loss.detach()),
                               float(jnp.mean(rad ** 2)), rtol=1e-5)


def test_mesh_is_not_ported():
    with pytest.raises(NotImplementedError, match="item 9"):
        make_loss_fn(RenderConfig(), mesh="rays")
    with pytest.raises(NotImplementedError, match="item 9"):
        make_train_step(torch.optim.SGD([torch.zeros(1)], lr=0.1),
                        RenderConfig(), mesh="rays")
