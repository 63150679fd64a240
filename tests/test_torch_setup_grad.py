"""The training set-up (``models/camera.py`` `set_up_frame` with a camera
leaf that needs autograd): kernel K11 forward and kernel K13 backward as
one autograd Function, and K13's plain twin (``models/setup_grad.py``).

On the CPU (the Function runs K11's plain version and K13's twin):
- the six camera leaves' gradients for a random cotangent of the rays
  against ``jax.grad`` of the JAX package's `Camera.ray_directions`, over
  tests/test_torch_frame_setup.py's cases (odd and even resolutions, a
  band with ``row0``, two and nine objects, float64), at
  tests/test_torch_train.py's tolerances: rtol 1e-4 and atol 1e-5 *
  max(|g|, |g_abs|) per leaf, g_abs the gradient for |cotangent|;
- the twin against ``torch.autograd`` through `frame_setup_reference` (the
  autograd chain it replaces), in float32 and float64: |g - g_autograd|
  <= 5e-5 (float32) or 1e-12 (float64) * max(|g_autograd|, |g_abs|) per
  leaf. The two differ in the order of their sums (one ``torch.sum`` of
  the rays' partials against autograd's leaf by leaf) and in a few
  regrouped roundings (``rsqrt``'s x^3 as x x x);
- only the leaves that require grad get one, bitwise the gradient they
  get when every leaf is trained.

On the card (marked ``gpu``; they skip here): K13 bitwise its twin on the
same cases at 96x64 (float32 and float64, a band), every leaf and a few;
a compiled fit step whose capture launches K11 once and K13 once and
never calls `frame_setup_reference`; two runs of one step with bitwise
the same camera gradients. The GPU tests import no JAX:
    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_setup_grad.py
"""

import numpy as np
import pytest
import torch

import cpp_cuda_raytracer_dev_torch as P
from cpp_cuda_raytracer_dev_torch.models import camera as camera_mod
from cpp_cuda_raytracer_dev_torch.models.camera import (
    _adjust, frame_setup_reference, set_up_frame)
from cpp_cuda_raytracer_dev_torch.models.setup_grad import \
    frame_setup_grad_reference
from cpp_cuda_raytracer_dev_torch.ops.cuda import shade as k11
from test_torch_frame_setup import CASES, _case, _scene

LEAVES = P.Camera.LEAVES
TOL = {torch.float32: 5e-5, torch.float64: 1e-12}
SUBSETS = [("pos",), ("look_at",), ("up",), ("film_w", "film_h"),
           ("focal",), ("pos", "up", "focal")]


def _cotangent(case, dtype, device="cpu", res=None):
    w, h, row0, band_h = *(res or CASES[case][:2]), *CASES[case][2:4]
    rows = h - row0 if band_h is None else band_h
    ct = np.random.default_rng(1).normal(size=(rows * w, 3))
    return torch.as_tensor(ct, dtype=dtype, device=device)


def _function_grads(cam, poses, method, row0, band_h, ct):
    """The trained leaves' gradients of sum(ct * rays) through
    `set_up_frame`."""
    leaves = [getattr(cam, f) for f in LEAVES if getattr(cam, f).requires_grad]
    setup = set_up_frame(cam, poses, method, row0, band_h)
    return torch.autograd.grad((setup.rmd * ct).sum(), leaves)


@pytest.mark.parametrize("case", list(CASES))
def test_function_matches_jax_grad(case):
    import jax
    import jax.numpy as jnp

    import cpp_cuda_raytracer_dev_tpu as J
    w, h, row0, band_h, _, dtype, _ = CASES[case]
    rows = h - row0 if band_h is None else band_h
    ct = _cotangent(case, dtype)
    f64 = dtype == torch.float64
    with jax.enable_x64(f64):
        jdt = jnp.float64 if f64 else jnp.float32
        jcam = J.Camera.create(w, h, pos=[0.1, 0.3, -3.0],
                               look_at=[0.0, 0.1, 0.0], up=[0.1, 1.0, 0.0],
                               dtype=jdt)

        def loss(c, g):
            return jnp.sum(c.ray_directions()[row0 * w:(row0 + rows) * w]
                           * g)
        jg = jax.grad(loss)(jcam, jnp.asarray(ct.numpy()))
        want = {f: np.asarray(getattr(jg, f), np.float64) for f in LEAVES}
    cam, poses, method, _, _ = _case(case, "cpu")
    cam.requires_grad_()
    got = _function_grads(cam, poses, method, row0, band_h, ct)
    g_abs = _function_grads(cam, poses, method, row0, band_h, ct.abs())
    for f, g, ga in zip(LEAVES, got, g_abs):
        np.testing.assert_allclose(
            g.numpy(), want[f], rtol=1e-4,
            atol=1e-5 * max(np.abs(want[f]).max(), float(ga.abs().max())),
            err_msg=f)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", list(CASES))
def test_twin_matches_autograd(case, dtype):
    w, h, row0, band_h = CASES[case][:4]
    cam = P.Camera.create(w, h, pos=[0.1, 0.3, -3.0], look_at=[0.0, 0.1, 0.0],
                          up=[0.1, 1.0, 0.0], device="cpu",
                          dtype=dtype).requires_grad_()
    leaves = [getattr(cam, f) for f in LEAVES]
    ct = _cotangent(case, dtype)

    def autograd(g):
        rmd = frame_setup_reference(cam, [], "fixed", row0, band_h).rmd
        return torch.autograd.grad((rmd * g).sum(), leaves)
    want, g_abs = autograd(ct), autograd(ct.abs())
    got = frame_setup_grad_reference(leaves, ct, w, h, row0, _adjust(w),
                                     _adjust(h), [True] * 6)
    for f, x, y, ya in zip(LEAVES, got, want, g_abs):
        assert x.shape == y.shape and x.dtype == y.dtype, f
        scale = max(float(y.abs().max()), float(ya.abs().max()))
        assert float((x - y).abs().max()) <= TOL[dtype] * scale, f


@pytest.mark.parametrize("trained", SUBSETS)
def test_only_requested_leaves_get_a_gradient(trained, monkeypatch):
    case = "band bin"
    ct = _cotangent(case, torch.float32)
    cam, poses, method, row0, band_h = _case(case, "cpu")
    cam.requires_grad_()
    every = dict(zip(LEAVES, _function_grads(cam, poses, method, row0,
                                             band_h, ct)))
    needs = []

    def twin(*args):
        needs.append(tuple(args[-1]))
        return frame_setup_grad_reference(*args)
    monkeypatch.setattr(camera_mod, "frame_setup_grad_reference", twin)
    cam, poses, method, row0, band_h = _case(case, "cpu")
    for f in trained:
        getattr(cam, f).requires_grad_()
    setup = set_up_frame(cam, poses, method, row0, band_h)
    (setup.rmd * ct).sum().backward()
    assert needs == [tuple(f in trained for f in LEAVES)]
    for f in LEAVES:
        g = getattr(cam, f).grad
        if f in trained:
            assert torch.equal(g, every[f]), f
        else:
            assert g is None, f


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_twin_on_gpu(case):
    _cuda()
    cam, _, _, row0, band_h = _case(case, "cuda", (96, 64))
    w, h = cam.res_w, cam.res_h
    ct = _cotangent(case, cam.pos.dtype, "cuda", (96, 64))
    leaves = [getattr(cam, f) for f in LEAVES]
    for need in ([True] * 6, [True, False, False, True, False, True]):
        args = (leaves, ct, w, h, row0, _adjust(w), _adjust(h), need)
        before = k11.frame_setup_grad.launches
        with torch.no_grad():
            got = k11.frame_setup_grad(*args)
            torch.cuda.synchronize()
            want = frame_setup_grad_reference(*args)
        assert k11.frame_setup_grad.launches == before + 1
        for f, x, y in zip(LEAVES, got, want):
            assert (x is None) == (y is None), f
            if y is not None:
                assert x.dtype == y.dtype and x.shape == y.shape, f
                assert torch.equal(x, y), (case, need, f)


def _fit(device):
    """A one-object bin scene whose pose and camera are trained towards the
    frame of a nearby pose, and its target."""
    _, scene = _scene(1, device)
    cam = P.Camera.create(96, 64, pos=[0.1, 0.3, -4.0], look_at=[0, 0, 0],
                          up=[0, 1, 0], device=device)
    config = P.RenderConfig(method="bin", bin_chunk=128)
    with torch.no_grad():
        target = P.render(scene, cam, config).radiance.clone()
        scene.objects[0].pose.translation += torch.tensor(
            [0.01, -0.02, 0.0], device=device)
    cam.requires_grad_()
    leaves = [*cam.parameters(), scene.objects[0].pose.quat,
              scene.objects[0].pose.translation]
    for p in leaves:
        p.requires_grad_()
    return scene, cam, config, target, leaves


@pytest.mark.gpu
def test_compiled_fit_step_launches_k11_and_k13_once_on_gpu(monkeypatch):
    from cpp_cuda_raytracer_dev_torch.parallel.render_pjit import \
        make_train_step_jit
    from cpp_cuda_raytracer_dev_torch.utils import graphs
    _cuda()
    scene, cam, config, target, leaves = _fit("cuda")

    def refuse(*args, **kw):
        raise AssertionError("the plain set-up ran")
    monkeypatch.setattr(camera_mod, "frame_setup_reference", refuse)
    counted = []
    capture = graphs.capture

    def counting(fn, pool, warm_up=True):
        def body():
            before = (k11.frame_setup.launches,
                      k11.frame_setup_grad.launches)
            out = fn()
            if torch.cuda.is_current_stream_capturing():
                counted.append((k11.frame_setup.launches - before[0],
                                k11.frame_setup_grad.launches - before[1]))
            return out
        return capture(body, pool, warm_up)
    monkeypatch.setattr(graphs, "capture", counting)
    step = make_train_step_jit(torch.optim.SGD(leaves, lr=1e-3), config)
    for _ in range(3):
        step({"scene": scene, "camera": cam}, target)
    torch.cuda.synchronize()
    assert counted[0] == (1, 1)
    assert all(c == (0, 0) for c in counted[1:])   # G2, the optimizer's
    assert all(p.grad is not None for p in cam.parameters())


@pytest.mark.gpu
def test_camera_grads_repeat_bitwise_on_gpu():
    from cpp_cuda_raytracer_dev_torch.parallel.render_pjit import \
        make_train_step
    _cuda()
    runs = []
    for _ in range(2):
        scene, cam, config, target, leaves = _fit("cuda")
        step = make_train_step(torch.optim.SGD(leaves, lr=1e-3), config)
        launches = k11.frame_setup_grad.launches
        step({"scene": scene, "camera": cam}, target)
        torch.cuda.synchronize()
        assert k11.frame_setup_grad.launches == launches + 1
        runs.append([p.grad.clone() for p in cam.parameters()])
    for f, a, b in zip(LEAVES, *runs):
        assert torch.equal(a, b), f
