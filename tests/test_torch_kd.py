"""The KD path of the port: `kd_intersect` (kernel K7 on the card) and
`kd_intersect_plain` (its plain version), and the ``"kd"`` frame and step
through `render_jit` and `make_train_step_jit`.

On the CPU:
- `kd_intersect_plain` against the JAX package's `kd_intersect` on the same
  numpy KD tree at leaf sizes 1, 8 and 128: ids equal, t within rtol 4e-6
  and the port's t within rtol 2e-6 of the hit triangle's float64 t (XLA
  on the CPU contracts multiply-adds into FMAs, PyTorch rounds each
  operation: on a grazing hit at leaf 1 JAX's t is 1.3e-6 off the float64
  t and the port's 0.7e-6 the other way); in float64 under
  ``jax.enable_x64`` at rtol 1e-12, as tests/test_torch_f64.py; on CPU tensors `kd_intersect` is the plain
  version, bit for bit;
- `render_jit(method="kd")` bitwise `render`'s;
- `make_train_step_jit` with ``"kd"`` and with ``"raster"`` (which it runs
  uncaptured, as `render_jit` does) bitwise `make_train_step` after 3
  steps.

On the card (marked ``gpu``; they skip here): K7 bitwise its plain version
in t and ids on a sphere at leaf sizes 1, 8 and 128, on a scene whose every
triangle is there twice (every hit an exact tie), and on axis-aligned rays
through split planes (a zero direction component on a box plane makes the
slab test NaN), in float32 and float64; the kd frame captured by
`render_jit` with K7 inside the replay; the compiled kd and raster steps
bitwise the eager ones; the wrapper refusing a tree deeper than its stack
and rays of a dtype it does not take. The JAX package is imported inside
the CPU tests, so that on the card's machine, which has no JAX, they run
with
    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_kd.py
"""

import dataclasses

import numpy as np
import pytest
import torch

import cpp_cuda_raytracer_dev_torch as P
from cpp_cuda_raytracer_dev_torch.accel.kd_build import build_kd
from cpp_cuda_raytracer_dev_torch.accel.traverse import (KDTables,
                                                         kd_intersect,
                                                         kd_intersect_plain)
from cpp_cuda_raytracer_dev_torch.models import renderer
from cpp_cuda_raytracer_dev_torch.ops.cuda import kd_traverse as k7
from cpp_cuda_raytracer_dev_torch.ops.intersect import mt_test
from cpp_cuda_raytracer_dev_torch.ops.quaternion import from_axis_angle
from cpp_cuda_raytracer_dev_torch.parallel.render_pjit import (
    make_train_step, make_train_step_jit)
from cpp_cuda_raytracer_dev_torch.utils.procgen import uv_sphere

RES_W, RES_H = 48, 32
FIELDS = ("image", "radiance", "hit_t", "hit_tri", "hit_obj", "normal",
          "point")


def _sphere():
    return uv_sphere(24, 24, roughness=0.03)


def _tables(tv, leaf, device, dtype=torch.float32):
    tree = build_kd(tv.min(axis=1), tv.max(axis=1), leaf)
    return KDTables.from_tree(tree, P.Triangles.from_vertices(
        tv, device=device, dtype=dtype))


def _camera(device, pos=(0.1, 0.3, -3.0), dtype=torch.float32,
            res=(RES_W, RES_H)):
    return P.Camera.create(*res, pos=list(pos), look_at=[0.0, 0.0, 0.0],
                           up=[0.0, 1.0, 0.0], film_h=0.024, focal=0.055,
                           device=device, dtype=dtype)


def _rays(device, dtype=torch.float32):
    cam = _camera(device, dtype=dtype)
    with torch.no_grad():
        return cam.pos.detach().clone(), cam.ray_directions()


def _grid_mesh(n: int = 8) -> np.ndarray:
    """A height field of n x n quads over [-1, 1]^2 whose vertices lie on
    exact binary fractions (x = 0 and y = 0 among them), so that split
    planes and box faces fall exactly on the axis-aligned rays below, in
    front of a small sphere."""
    xs = np.linspace(-1.0, 1.0, n + 1)

    def v(i, j):
        return (xs[i], xs[j], 0.125 * ((i + 2 * j) % 3))
    tv = []
    for i in range(n):
        for j in range(n):
            tv.append([v(i, j), v(i + 1, j), v(i, j + 1)])
            tv.append([v(i + 1, j + 1), v(i, j + 1), v(i + 1, j)])
    sphere = uv_sphere(12, 12) * 0.5 + np.array([0.0, 0.0, -1.0])
    return np.concatenate([np.asarray(tv, np.float32), sphere])


def _axis_rays(dtype):
    """Directions with a zero component: (0, s, 1), (s, 0, 1) and the six
    axes, normalised (a zero stays zero)."""
    s = np.linspace(-0.4, 0.4, 33)
    d = np.array([(0.0, v, 1.0) for v in s] + [(v, 0.0, 1.0) for v in s]
                 + [(0, 0, 1), (1, 0, 0), (0, 1, 0), (-1, 0, 0), (0, -1, 0),
                    (0, 0, -1), (0, 0.2, 0.9), (0.3, 0, 0.8)], np.float64)
    return torch.tensor(d / np.linalg.norm(d, axis=1, keepdims=True),
                        dtype=dtype)


def _assert_bitwise(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert torch.equal(x, y), f


# ---- on the CPU ----

@pytest.mark.parametrize("leaf", [1, 8, 128])
def test_kd_plain_matches_jax(leaf):
    import jax.numpy as jnp

    import cpp_cuda_raytracer_dev_tpu as J
    from cpp_cuda_raytracer_dev_tpu.accel import traverse as jtr
    tv = _sphere()
    tree = build_kd(tv.min(axis=1), tv.max(axis=1), leaf)
    o, d = _rays("cpu")
    jtab = jtr.KDTables.from_tree(tree, J.Triangles.from_vertices(tv))
    jh = jtr.kd_intersect(jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                          jtab, ray_chunk=0)
    tab = KDTables.from_tree(tree, P.Triangles.from_vertices(tv,
                                                             device="cpu"))
    h = kd_intersect_plain(o, d, tab, ray_chunk=0)
    jtri = np.asarray(jh.tri)
    assert (jtri >= 0).mean() > 0.5 and (jtri < 0).any()
    np.testing.assert_array_equal(h.tri.numpy(), jtri)
    np.testing.assert_array_equal(h.obj.numpy(), np.asarray(jh.obj))
    np.testing.assert_allclose(h.t.numpy(), np.asarray(jh.t), rtol=4e-6)
    # the port's t within 2e-6 of the hit triangle's float64 t
    hit = h.tri >= 0
    tris = P.Triangles.from_vertices(tv, device="cpu", dtype=torch.float64)
    ids = h.tri[hit].long()
    with torch.no_grad():
        t64, _, _, _ = mt_test(o.double(), d[hit].double(), tris.p1[ids],
                               tris.e1[ids], tris.e2[ids])
    np.testing.assert_allclose(h.t[hit].numpy(), t64.numpy(), rtol=2e-6)
    # on CPU tensors the wrapper is the plain version; runs change nothing
    for got in (kd_intersect(o, d, tab), kd_intersect_plain(o, d, tab,
                                                            ray_chunk=500)):
        assert torch.equal(got.t, h.t) and torch.equal(got.tri, h.tri)


@pytest.mark.parametrize("leaf", [1, 8, 128])
def test_kd_plain_f64_matches_jax(leaf):
    import jax
    import jax.numpy as jnp

    import cpp_cuda_raytracer_dev_tpu as J
    from cpp_cuda_raytracer_dev_tpu.accel import traverse as jtr
    tv = _sphere()
    tree = build_kd(tv.min(axis=1), tv.max(axis=1), leaf)
    o, d = _rays("cpu", torch.float64)
    with jax.enable_x64(True):
        jtab = jtr.KDTables.from_tree(tree, J.Triangles.from_vertices(
            tv, dtype=jnp.float64))
        jh = jtr.kd_intersect(jnp.asarray(o.numpy()),
                              jnp.asarray(d.numpy()), jtab, ray_chunk=0)
        jtri, jt = np.asarray(jh.tri), np.asarray(jh.t)
    assert jt.dtype == np.float64
    tab = KDTables.from_tree(tree, P.Triangles.from_vertices(
        tv, device="cpu", dtype=torch.float64))
    h = kd_intersect_plain(o, d, tab, ray_chunk=0)
    assert h.t.dtype == torch.float64
    assert (jtri >= 0).mean() > 0.5
    np.testing.assert_array_equal(h.tri.numpy(), jtri)
    np.testing.assert_allclose(h.t.numpy(), jt, rtol=1e-12)


def _kd_scene(device, angle=0.6):
    tv = np.roll(_sphere(), -_sphere().shape[0] // 2, axis=0)
    color = np.random.default_rng(0).uniform(0.1, 1.0, (tv.shape[0], 3))
    tris = P.Triangles.from_vertices(tv, device=device,
                                     color=color.astype(np.float32))
    pose = P.Pose(from_axis_angle([0.3, 1.0, 0.1], angle, device=device),
                  torch.tensor([0.15, -0.1, 0.2], device=device))
    return P.Scene([P.SceneObject(tris, pose)]), tv


def test_render_jit_kd_is_bitwise_render():
    scene, tv = _kd_scene("cpu")
    accel = (_tables(tv, 8, "cpu"),)
    cfg = P.RenderConfig(method="kd")
    assert renderer.jit_captures(cfg)
    for pos in ((0.1, 0.3, -3.0), (0.3, -0.2, -2.6)):
        cam = _camera("cpu", pos)
        out = P.render_jit(scene, cam, cfg, accel)
        _assert_bitwise(out, P.render(scene, cam, cfg, accel))
        assert (out.hit_tri >= 0).float().mean() > 0.3


def _compiled_against_eager(device, method, steps=3):
    """Parameters and losses of ``steps`` compiled and eager all-leaves
    steps from twin parameter sets."""
    scene0, tv = _kd_scene(device)
    cfg = P.RenderConfig(method=method)
    accel = (_tables(tv, 8, device),) if method == "kd" else None
    target = P.render(scene0, _camera(device), cfg, accel).radiance.clone()
    runs = []
    for make in (make_train_step_jit, make_train_step):
        scene, _ = _kd_scene(device, 0.65)
        cam = _camera(device).requires_grad_()
        params = {"scene": scene, "camera": cam}
        leaves = [*scene.parameters(), *cam.parameters()]
        step = make(torch.optim.SGD(leaves, lr=1e-3), cfg, accel=accel)
        losses = [step(params, target) for _ in range(steps)]
        runs.append((losses, [p.detach().clone() for p in leaves]))
    return runs


@pytest.mark.parametrize("method", ["kd", "raster"])
def test_compiled_step_kd_and_raster_equal_eager(method):
    (jl, jp), (el, ep) = _compiled_against_eager("cpu", method)
    assert float(el[-1]) > 0
    for a, b in zip(jl, el):
        assert torch.equal(a, b)
    for a, b in zip(jp, ep):
        assert torch.equal(a, b)


# ---- on the card ----

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K7 is a CUDA kernel with no CPU "
                    "mode")
    return torch.device("cuda", 0)


def _device_kernels(fn) -> dict:
    """{device kernel name: instances} of one call of ``fn`` under the
    profiler, a replayed graph's kernels included."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {a.key: a.count for a in prof.key_averages()
            if a.device_type == DeviceType.CUDA}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("scene,leaf", [("sphere", 1), ("sphere", 8),
                                        ("sphere", 128), ("ties", 8),
                                        ("ties", 128), ("axis", 1),
                                        ("axis", 4)])
def test_k7_is_bitwise_plain_on_gpu(scene, leaf, dtype):
    dev = _cuda()
    tv = {"sphere": uv_sphere(50, 50), "ties": np.concatenate(
        [uv_sphere(50, 50)] * 2), "axis": _grid_mesh()}[scene]
    tab = _tables(tv, leaf, dev, dtype)
    if scene == "axis":
        cases = [(torch.tensor(o, dtype=dtype, device=dev),
                  _axis_rays(dtype).to(dev))
                 for o in ((0.0, 0.0, -3.0), (0.25, -0.5, -2.0))]
    else:
        cases = [_rays(dev, dtype)]
    for o, d in cases:
        launches = k7.kd_traverse.launches
        got = kd_intersect(o, d, tab)
        torch.cuda.synchronize()
        assert k7.kd_traverse.launches == launches + 1
        want = kd_intersect_plain(o, d, tab)
        assert got.t.dtype == dtype
        assert torch.equal(got.tri, want.tri)
        assert torch.equal(got.t, want.t)
        assert torch.equal(got.obj, want.obj)
        assert bool((want.tri >= 0).any())
    if scene == "ties":    # every hit is a tie between ids i and i + T / 2
        hit = got.tri >= 0
        assert bool((got.tri[hit] < tv.shape[0] // 2).any())


@pytest.mark.gpu
def test_render_jit_kd_replays_k7_on_gpu():
    dev = _cuda()
    scene, tv = _kd_scene(dev)
    accel = (_tables(tv, 8, dev),)
    cfg = P.RenderConfig(method="kd")
    cam = _camera(dev)
    first = P.render_jit(scene, cam, cfg, accel)
    captures = renderer.FRAME_GRAPHS.captures
    for angle in (0.6, 0.7):             # new leaves, the same graph
        scene2, _ = _kd_scene(dev, angle)
        _assert_bitwise(P.render_jit(scene2, cam, cfg, accel),
                        P.render(scene2, cam, cfg, accel))
    assert renderer.FRAME_GRAPHS.captures == captures
    _assert_bitwise(first, P.render(scene, cam, cfg, accel))
    launches = k7.kd_traverse.launches
    seen = _device_kernels(lambda: P.render_jit(scene, cam, cfg, accel))
    assert k7.kd_traverse.launches == launches     # a replay, no launch
    assert sum(n for k, n in seen.items() if "kd_traverse_kernel" in k) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["kd", "raster"])
def test_compiled_step_kd_and_raster_on_gpu(method):
    dev = _cuda()
    (jl, jp), (el, ep) = _compiled_against_eager(dev, method)
    for a, b in zip(jl, el):
        assert torch.equal(a, b)
    for a, b in zip(jp, ep):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_k7_refuses_what_it_does_not_take_on_gpu():
    dev = _cuda()
    tab = _tables(_sphere(), 8, dev)
    o, d = _rays(dev)
    deep = dataclasses.replace(tab, max_depth=k7.max_stack() - 1)
    with pytest.raises(ValueError, match="stack"):
        kd_intersect(o, d, deep)
    for oo, dd in ((o.half(), d.half()), (o.double(), d.double()),
                   (o, d.double())):
        with pytest.raises(TypeError, match="float32 or float64"):
            kd_intersect(oo, dd, tab)
