"""PyTorch port vs the JAX package: the public names that the port adds to
match JAX's (`RayBuffers`, `Camera.num_pixels`, `default_colors`,
`Triangles.n`, `Triangles.num_triangles`, the vecmath helpers `norm`,
`normalize_with_invnorm`, `quake_rsqrt`, `reflect`, `sign_bits`, and
`shade.phong_radiance`) and the package's top-level exports.

Inputs are made with numpy from a seed and fed to both. Tolerances: exact
for ints, signs, shapes and the bit-trick `quake_rsqrt` (the same float32
operations in the same order); rtol 1e-6, atol 1e-7 for float math (XLA on
the CPU contracts multiply-adds into FMAs, PyTorch rounds each product),
as tests/test_torch_core.py; `phong_radiance` at rtol 1e-5, atol 1e-6
(its ``** exponent`` carries those ulps further).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpp_cuda_raytracer_dev_tpu as J
import cpp_cuda_raytracer_dev_torch as P
from cpp_cuda_raytracer_dev_tpu.ops import shade as jshade
from cpp_cuda_raytracer_dev_tpu.ops import vecmath as jvm
from cpp_cuda_raytracer_dev_torch.ops import shade as pshade
from cpp_cuda_raytracer_dev_torch.ops import vecmath as pvm
from cpp_cuda_raytracer_dev_torch.utils.procgen import uv_sphere

RTOL, ATOL = 1e-6, 1e-7


def _vectors(seed, n=257):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, 3)).astype(np.float32)
    a[:5] = [[0.0, -0.0, 1.0], [-1.0, 0.0, 0.0], [1e-3, -2e3, 5.0],
             [3.0, 4.0, 0.0], [-0.5, -0.5, -0.5]]
    return a


def test_top_level_exports_are_jax_names():
    """Every name JAX's package exports, the port exports too, except
    ``__version__``; the port adds its own (accels, Projection, ...)."""
    missing = sorted(set(J.__all__) - set(P.__all__))
    assert missing == []
    for name in P.__all__:
        assert getattr(P, name) is not None, name
    assert P.render_jit.__module__.endswith("models.renderer")
    assert P.read_ply is P.io.ply.read_ply
    assert P.load_mesh is P.io.ply.load_mesh


@pytest.mark.parametrize("res", [(96, 64), (33, 17)])
def test_ray_buffers_match_jax(res):
    kw = dict(pos=[0.3, 0.2, -3.0], look_at=[0.1, 0.0, -0.2],
              up=[0.0, 1.0, 0.0], film_h=0.024, focal=0.055)
    jcam = J.Camera.create(*res, **kw)
    pcam = P.Camera.create(*res, **kw, device="cpu")
    assert pcam.num_pixels == jcam.num_pixels == res[0] * res[1]
    jb = J.RayBuffers.create(jcam, draw_distance=250.0)
    pb = P.RayBuffers.create(pcam, draw_distance=250.0)
    for f in ("rmd", "inv_rmd", "sign_rmd", "dist", "rmi"):
        j, p = np.asarray(getattr(jb, f)), getattr(pb, f).numpy()
        assert p.dtype == j.dtype and p.shape == j.shape, f
        if f == "rmd":
            np.testing.assert_allclose(p, j, rtol=RTOL, atol=ATOL)
        elif f == "inv_rmd":
            # 1 / rmd, as JAX's: near-zero components turn rmd's absolute
            # ulps into relative ones, so hold each to its own rmd exactly
            one = np.float32(1.0)
            np.testing.assert_array_equal(p, one / pb.rmd.numpy())
            np.testing.assert_array_equal(j, one / np.asarray(jb.rmd))
        else:
            np.testing.assert_array_equal(p, j, err_msg=f)


@pytest.mark.parametrize("n", [0, 1, 7])
def test_default_colors_match_jax(n):
    j, p = J.default_colors(n), P.default_colors(n)
    assert p.dtype == j.dtype and p.shape == j.shape == (n, 3)
    np.testing.assert_array_equal(p, j)
    p[:] = 0                         # a copy, not a view of a shared row
    assert (P.default_colors(2) > 0).all()


def test_triangle_normals_and_count_match_jax():
    tv = uv_sphere(10, 12, roughness=0.05)
    jt = J.Triangles.from_vertices(tv)
    pt = P.Triangles.from_vertices(tv, device="cpu")
    assert pt.num_triangles == jt.num_triangles == tv.shape[0]
    with torch.no_grad():
        pn = pt.n.numpy()
    jn = np.asarray(jt.n)
    assert pn.shape == jn.shape == (tv.shape[0], 3)
    # the sphere's pole triangles have zero area: both clamp, neither NaN
    assert np.isfinite(pn).all() and np.isfinite(jn).all()
    np.testing.assert_allclose(pn, jn, rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_vecmath_matches_jax(seed):
    a, b = _vectors(seed), _vectors(seed + 10)
    unit_b = b / np.linalg.norm(b, axis=1, keepdims=True)
    ta, tb, tub = (torch.tensor(x) for x in (a, b, unit_b))
    np.testing.assert_allclose(pvm.norm(ta).numpy(),
                               np.asarray(jvm.norm(jnp.asarray(a))),
                               rtol=RTOL, atol=ATOL)
    pu, pinv = pvm.normalize_with_invnorm(ta)
    ju, jinv = jvm.normalize_with_invnorm(jnp.asarray(a))
    np.testing.assert_allclose(pu.numpy(), np.asarray(ju), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(pinv.numpy(), np.asarray(jinv), rtol=RTOL)
    np.testing.assert_allclose(
        pvm.reflect(ta, tub).numpy(),
        np.asarray(jvm.reflect(jnp.asarray(a), jnp.asarray(unit_b))),
        rtol=RTOL, atol=1e-6)
    js, ps = np.asarray(jvm.sign_bits(jnp.asarray(a))), \
        pvm.sign_bits(ta).numpy()
    assert ps.dtype == js.dtype == np.int32
    np.testing.assert_array_equal(ps, js)


@pytest.mark.parametrize("iters", [0, 1, 8])
def test_quake_rsqrt_matches_jax(iters):
    rng = np.random.default_rng(iters)
    s = np.concatenate([rng.uniform(1e-6, 1e6, 500),
                        [1.0, 2.0, 4.0, 0.25, 3.0e38]]).astype(np.float32)
    j = np.asarray(jvm.quake_rsqrt(jnp.asarray(s), iters))
    p = pvm.quake_rsqrt(torch.tensor(s), iters).numpy()
    assert p.dtype == j.dtype == np.float32
    np.testing.assert_array_equal(p, j)
    if iters == 8:
        np.testing.assert_allclose(p[:500], 1.0 / np.sqrt(s[:500]),
                                   rtol=1e-6)


def test_phong_radiance_matches_jax():
    rng = np.random.default_rng(5)
    n = 300
    point = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    normal = _vectors(6, n)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    ray = _vectors(7, n)
    ray /= np.linalg.norm(ray, axis=1, keepdims=True)
    color = rng.uniform(0.1, 1.0, (n, 3)).astype(np.float32)
    jp = J.PhongParams.reference()
    pp = P.PhongParams.reference(device="cpu")
    j = np.asarray(jshade.phong_radiance(*(jnp.asarray(x) for x in
                                           (point, normal, ray, color)), jp))
    with torch.no_grad():
        p = pshade.phong_radiance(*(torch.tensor(x) for x in
                                    (point, normal, ray, color)), pp)
        pc = torch.stack(pshade.phong_radiance_c(
            *(tuple(torch.tensor(x).unbind(1)) for x in
              (point, normal, ray, color)), pp), dim=1)
    assert p.shape == j.shape == (n, 3) and p.dtype == torch.float32
    np.testing.assert_allclose(p.numpy(), j, rtol=1e-5, atol=1e-6)
    # the (R, 3) form and the componentized one agree
    np.testing.assert_allclose(p.numpy(), pc.numpy(), rtol=1e-5, atol=1e-6)
