"""The training shading (``models/shade_grad.py``): kernel K10 forward and
kernel K12 backward as one autograd Function, and K12's plain twin.

On the CPU (the Function runs the plain versions of both kernels):
- the Function's gradients against ``torch.autograd`` through
  `shade_compose_reference` (the autograd chain it replaces), on one and
  two posed objects, every leaf trained or the pose, Phong parameters and
  camera only, in float32 and float64, with a cotangent of radiance only
  and of radiance, normal and point, and with every hit moved to a
  triangle its ray misses (the recompute rejects it and t stays the
  traversal's, so hit t's gradient is compared too). Tolerance: |g - g_autograd| <= 5e-5 * max|g_autograd| per
  leaf in float32, 1e-12 in float64. The two differ only in the order of
  their sums (the twin sums the rays' partials with one ``torch.sum``,
  autograd leaf by leaf) and in a few regrouped roundings (``rsqrt``'s
  x^3 as x x x, not ``pow(3)``), each a few units in the last place of a
  ray's term; the largest seen is 6.1e-6 (float32) and 1.4e-14 (float64)
  of the leaf's largest entry;
- edge rays, each against autograd at the same tolerance and finite: a
  miss, a hit of a zero-area triangle (det = 0 and |e1 x e2| = 0, below
  the clamp), a hit its recompute rejects, and rays whose reflection is
  at right angles to them and whose light grazes the surface (sum(r) = 0
  under ``exponent`` and L.N = 0 under ``abs``); hit t's gradient is
  compared with the leaves';
- the routing: with autograd on and an input that requires grad
  `shade_and_compose` takes the Function, whose backward calls K12's twin
  once on CPU tensors (and raises on a second derivative); with autograd
  off it calls `shade_compose` (K10's wrapper) and builds no graph;
  outputs bitwise the autograd chain's. K12's launcher refuses CPU
  tensors.

On the card (marked ``gpu``; they skip here): K12 bitwise its twin (the
partials, the constants, the cotangents of the rays, the tables' rows and
hit t) on the cases of tests/test_torch_shade_kernel.py, every cotangent
set; and a captured `make_train_step_jit` step bitwise between the kernel
route and the twin route, the counters showing which ran:
    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_shade_grad.py
"""

import pytest
import torch

from cpp_cuda_raytracer_dev_torch import (Camera, PhongParams, Pose,
                                          RenderConfig, Scene, SceneObject,
                                          Triangles, render)
from cpp_cuda_raytracer_dev_torch.models import renderer
from cpp_cuda_raytracer_dev_torch.models import shade_grad as sg
from cpp_cuda_raytracer_dev_torch.models.renderer import (
    shade_and_compose, shade_compose_reference)
from cpp_cuda_raytracer_dev_torch.ops.cuda import shade as k10
from cpp_cuda_raytracer_dev_torch.ops.intersect import Hit
from test_torch_shade_kernel import CASES, OUT, _edge_hit, _world

TOL = {torch.float32: 5e-5, torch.float64: 1e-12}
TRAINED = ("all", "pose/phong/camera")
K12 = k10.shade_grad         # the wrapper, whose counter a patch keeps


def _trained(scene, cam, which):
    """The leaves a step trains: every leaf, or the poses, the Phong
    parameters and the camera (the tables frozen)."""
    cam.requires_grad_(True)
    if which == "pose/phong/camera":
        for obj in scene.objects:
            obj.tris.requires_grad_(False)
    names = [n for n, p in scene.named_parameters() if p.requires_grad]
    names += ["cam." + n for n, _ in cam.named_parameters()]
    return names, [p for p in scene.parameters() if p.requires_grad] + list(
        cam.parameters())


def _grads(shade, scene, cam, config, hit, cts, leaves):
    """The leaves' gradients of sum(output * cotangent) through ``shade``,
    from the camera's own rays (so that they reach the camera)."""
    rmd = cam.ray_directions()
    out = shade(scene, cam.pos, rmd, hit, config)
    loss = sum((out[f] * c).sum() for f, c in zip(
        ("radiance", "normal", "point"), cts) if c is not None)
    return torch.autograd.grad(loss, leaves, allow_unused=True)


def _compare(names, got, want, dtype):
    for n, g, w in zip(names, got, want):
        assert (g is None) == (w is None), n
        if w is None:
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, n
        assert torch.isfinite(g).all(), n
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= TOL[dtype] * scale, (
            n, float((g - w).abs().max()), scale)


def _cotangents(n, dtype, which):
    g = torch.Generator().manual_seed(3)
    full = [torch.randn(n, 3, generator=g, dtype=dtype) for _ in range(3)]
    return full if which == "radiance, normal, point" else [full[0], None,
                                                            None]


@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("cts", ["radiance", "radiance, normal, point"])
@pytest.mark.parametrize("trained", TRAINED)
@pytest.mark.parametrize("case", ["one object", "two posed objects",
                                  "float64", "float64 two objects"])
def test_function_matches_autograd(case, trained, cts, edge):
    scene, cam, config, _, _, hit = _world(case, "cpu")
    names, leaves = _trained(scene, cam, trained)
    if edge:
        # the rejected recomputes keep the traversal's t, which then
        # carries the cotangent
        hit = _edge_hit(hit)
        hit.t.requires_grad_(True)
        names, leaves = [*names, "hit.t"], [*leaves, hit.t]
    dtype = CASES[case][1]
    ct = _cotangents(hit.t.shape[0], dtype, cts)
    got = _grads(shade_and_compose, scene, cam, config, hit, ct, leaves)
    want = _grads(shade_compose_reference, scene, cam, config, hit, ct,
                  leaves)
    _compare(names, got, want, dtype)
    assert any(float(g.abs().max()) > 0 for g in got if g is not None)


def _edge_scene(dtype):
    """Four triangles, identity pose, four rays along +z from z = -1, each
    of one edge: triangle 0 (the plane z = 0, normal +z) hit where the
    light lies along +x in the plane (L.N = 0, and the reflection (1, 0,
    0) is at right angles to the ray: sum(r) = 0); triangle 1 of zero area
    (det = 0, |e1 x e2| = 0); triangle 2 hit but missed by its ray (the
    recompute rejects it, t stays the hit's); a miss."""
    def t(x):
        return torch.tensor(x, dtype=dtype)
    tv = t([[[-2.0, -2.0, 0.0], [6.0, -2.0, 0.0], [-2.0, 6.0, 0.0]],
            [[0.5, 0.5, 0.5], [0.5, 0.5, 0.5], [0.7, 0.5, 0.5]],
            [[5.0, 5.0, 1.0], [6.0, 5.0, 1.0], [5.0, 6.0, 1.0]],
            [[-1.0, 0.0, 2.0], [1.0, 0.0, 2.0], [0.0, 1.0, 2.0]]])
    tris = Triangles.from_vertices(tv, device="cpu", dtype=dtype,
                                   color=[[0.2, 0.5, 0.9]] * 4)
    phong = PhongParams(t([1.25, 0.25, 0.0]), t([1.0, 0.8, 0.6]), t(0.6),
                        t(0.3), t(5.0))
    scene = Scene([SceneObject(tris, Pose.identity(device="cpu",
                                                   dtype=dtype))], phong)
    cam = Camera.create(2, 2, pos=[0.25, 0.25, -1.0],
                        look_at=[0.25, 0.25, 0.0], up=[0.0, 1.0, 0.0],
                        device="cpu", dtype=dtype)
    hit = Hit(t=t([1.0, 1.5, 2.0, 400.0]),
              tri=torch.tensor([0, 1, 2, -1], dtype=torch.int32),
              obj=torch.tensor([0, 0, 0, -1], dtype=torch.int32))
    return scene, cam, hit


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_edge_rays_match_autograd(dtype):
    scene, cam, hit = _edge_scene(dtype)
    config = RenderConfig(method="fixed")
    names, leaves = _trained(scene, cam, "all")
    hit.t.requires_grad_(True)      # ray 2's t is the hit's
    names, leaves = [*names, "hit.t"], [*leaves, hit.t]
    # the four rays along +z: rmd from the camera's own leaves would not
    # be exact; the origin still carries autograd
    rmd = torch.tensor([[0.0, 0.0, 1.0]] * 4, dtype=dtype,
                       requires_grad=True)
    ct = _cotangents(4, dtype, "radiance, normal, point")
    outs = {}
    for name, shade in (("function", shade_and_compose),
                        ("autograd", shade_compose_reference)):
        out = shade(scene, cam.pos, rmd, hit, config)
        loss = sum((out[f] * c).sum() for f, c in zip(
            ("radiance", "normal", "point"), ct))
        outs[name] = (out, torch.autograd.grad(loss, [*leaves, rmd],
                                               allow_unused=True))
    (out, got), (ref, want) = outs["function"], outs["autograd"]
    for f in OUT:
        assert torch.equal(out[f].detach(), ref[f].detach()), f
    # the edges are what this scene says they are: ray 0 lit by neither
    # term (L.N = 0, sum(r) = 0), ray 1's normal clamped to 0, ray 2 at
    # the hit's t, ray 3 a miss
    rad = out["radiance"].detach()
    assert float(rad[0].abs().max()) == 0.0 == float(rad[3].abs().max())
    assert float(out["normal"][1].detach().abs().max()) == 0.0
    assert torch.equal(out["point"][2].detach(),
                       cam.pos.detach() + 2.0 * rmd[2].detach())
    _compare([*names, "rmd"], got, want, dtype)


def test_routing_by_autograd(monkeypatch):
    """Autograd on and an input that requires grad: the Function, whose
    backward calls K12's twin once on CPU tensors; off: K10's wrapper and
    no graph. The outputs are bitwise the autograd chain's either way."""
    scene, cam, config, origin, rmd, hit = _world("two posed objects",
                                                  "cpu")
    calls = {"shade_compose": 0, "shade_grad": 0}

    def spy(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return wrapped
    monkeypatch.setattr(renderer, "shade_compose",
                        spy("shade_compose", k10.shade_compose))
    monkeypatch.setattr(sg, "shade_grad_reference",
                        spy("shade_grad", sg.shade_grad_reference))
    plain = sg.shade_compose_grad.plain
    scene.phong.requires_grad_(True)
    on = shade_and_compose(scene, origin, rmd, hit, config)
    assert calls == {"shade_compose": 0, "shade_grad": 0}
    assert on["radiance"].grad_fn is not None
    on["radiance"].sum().backward()
    assert calls == {"shade_compose": 0, "shade_grad": 1}
    assert scene.phong.exponent.grad is not None
    assert sg.shade_compose_grad.plain == plain       # no CUDA call
    with pytest.raises(ValueError, match="no shade_grad kernel for cpu"):
        k10.shade_grad(scene, origin, rmd, hit, config,
                       (torch.ones_like(rmd), None, None), True, True, True,
                       True)
    with torch.no_grad():
        off = shade_and_compose(scene, origin, rmd, hit, config)
        ref = shade_compose_reference(scene, origin, rmd, hit, config)
    assert calls == {"shade_compose": 1, "shade_grad": 1}
    assert off["radiance"].grad_fn is None
    for f in OUT:
        assert torch.equal(on[f].detach(), ref[f]), f
        assert torch.equal(off[f], ref[f]), f


def test_second_derivative_raises():
    """The backward is one launch with no graph of its own: a second
    derivative through the Function raises instead of dropping terms."""
    scene, cam, config, origin, rmd, hit = _world("one object", "cpu")
    scene.phong.requires_grad_(True)
    out = shade_and_compose(scene, origin, rmd, hit, config)
    (g,) = torch.autograd.grad(out["radiance"].square().sum(),
                               [scene.phong.diffuse], create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        g.backward()


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_twin_on_gpu(case, edge):
    _cuda()
    scene, cam, config, origin, rmd, hit = _world(case, "cuda")
    if edge:
        hit = _edge_hit(hit)
    g = torch.Generator(device="cuda").manual_seed(5)
    full = [torch.randn(rmd.shape[0], 3, generator=g, device="cuda",
                        dtype=rmd.dtype) for _ in range(3)]
    n_obj = len(scene.objects)
    for mask in range(1, 8):
        cts = [full[k] if mask >> k & 1 else None for k in range(3)]
        args = (scene, origin, rmd, hit, config, cts, True, True, True, True)
        before = k10.shade_grad.launches
        with torch.no_grad():
            got = k10.shade_grad(*args)
            torch.cuda.synchronize()
            want = sg.shade_grad_reference(*args)
        assert k10.shade_grad.launches == before + -(-n_obj
                                                     // k10.max_objects())
        for name, x, y in zip(("partials", "consts", "rmd", "rows", "hit_t"),
                              got, want):
            assert x.dtype == y.dtype and x.shape == y.shape, name
            assert torch.equal(x, y), (case, mask, name)


@pytest.mark.gpu
@pytest.mark.parametrize("trained", TRAINED)
def test_compiled_step_kernel_route_is_twin_route_on_gpu(monkeypatch,
                                                         trained):
    """Three captured `make_train_step_jit` steps, K12 against its twin in
    its place: losses and parameters bitwise; K12 launched on the kernel
    route only, ``.plain`` counting the twin route's backward passes."""
    from cpp_cuda_raytracer_dev_torch.parallel.render_pjit import \
        make_train_step_jit
    dev = _cuda()
    _, cam0, config, *_ = _world("one object", "cuda")
    with torch.no_grad():
        target = render(_world("one object", "cuda")[0], cam0,
                        config).radiance.clone()
    runs = {}
    for route in ("kernel", "twin"):
        if route == "twin":
            monkeypatch.setattr(k10, "shade_grad", sg.shade_grad_reference)
        scene, cam, config, *_ = _world("one object", "cuda")
        with torch.no_grad():
            scene.objects[0].pose.translation += torch.tensor(
                [0.01, -0.02, 0.0], device=dev)
        _, leaves = _trained(scene, cam, trained)
        step = make_train_step_jit(torch.optim.SGD(leaves, lr=1e-3), config)
        launches, plain = K12.launches, sg.shade_compose_grad.plain
        losses = [step({"scene": scene, "camera": cam}, target)
                  for _ in range(3)]
        torch.cuda.synchronize()
        runs[route] = (losses, [p.detach().clone() for p in leaves],
                       K12.launches - launches,
                       sg.shade_compose_grad.plain - plain)
    (kl, kp, k_launch, k_plain), (tl, tp, t_launch, t_plain) = (
        runs["kernel"], runs["twin"])
    assert k_launch >= 1 and k_plain == 0
    assert t_launch == 0 and t_plain >= 1
    for a, b in zip(kl, tl):
        assert torch.equal(a, b)
    for a, b in zip(kp, tp):
        assert torch.equal(a, b)
