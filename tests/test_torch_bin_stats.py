"""The bin kernel's telemetry switch (kernel K3): the port's
``intersect_binned`` with ``with_stats`` against the JAX package's (whose
``pallas_bin_intersect2`` runs in interpret mode), and the kernel against
its plain version on the card.

Both packages bin the same triangles with the same Projection numbers (the
JAX one, copied), so the entry tables are equal. Tolerances: the winning
ids equal; t at rtol 2e-6 (the plain version rounds every product, XLA on
the CPU fuses a·b + c·d; see tests/test_torch_bin_kernel.py); ``steps``
(slices scanned per tile), ``entries`` and ``cross`` equal; ``chunks``
(blocks per tile) equal on every tile but the last, where the JAX count
also holds the padding items of its fixed-size work list,
``i_cap - sum(blocks)`` (they point at the dead chunk, whose gate never
opens, so ``steps`` does not count them).

The JAX package is imported inside the tests that use it, so that the GPU
test also runs where JAX is not installed:
    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_bin_stats.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from cpp_cuda_raytracer_dev_torch import Camera, RenderConfig, Triangles
from cpp_cuda_raytracer_dev_torch.accel.traverse import (bin_object,
                                                          intersect_binned)
from cpp_cuda_raytracer_dev_torch.models.camera import Projection
from cpp_cuda_raytracer_dev_torch.ops.cuda.bin_intersect import (
    bin_intersect, bin_intersect_reference, effective_esub)
from cpp_cuda_raytracer_dev_torch.utils.procgen import uv_sphere

RES_W, RES_H, TH, TW, CHUNK = 96, 64, 16, 32, 512
PROJ_FIELDS = ("origin", "n", "u", "v", "sx", "sy", "adjust_x", "adjust_y")


def _config(esub, with_stats=True):
    return RenderConfig(method="bin", tile_h=TH, tile_w=TW, bin_chunk=CHUNK,
                        with_stats=with_stats, bin_esub=esub)


@pytest.fixture(scope="module")
def both():
    import jax.numpy as jnp

    import cpp_cuda_raytracer_dev_tpu as J
    tv = uv_sphere(50, 50, roughness=0.03)
    jtris = J.Triangles.from_vertices(tv)
    jcam = J.Camera.create(RES_W, RES_H, pos=[0.1, 0.2, -2.2],
                           look_at=[0.0, 0.0, 0.0], up=[0.0, 1.0, 0.0],
                           film_h=0.024, focal=0.055)
    jproj = jcam.projection()
    ptris = Triangles.from_vertices(tv, device="cpu")
    pproj = Projection(**{f: torch.tensor(np.asarray(getattr(jproj, f)))
                          for f in PROJ_FIELDS})
    o = np.asarray(jcam.pos)
    return (jtris, jproj, jnp.asarray(o)), (ptris, pproj, torch.tensor(o)), tv


def _jax_stats(jside, esub):
    from cpp_cuda_raytracer_dev_tpu.accel.traverse import intersect_binned
    from cpp_cuda_raytracer_dev_tpu.utils.config import RenderConfig as JRC
    jtris, jproj, o = jside
    cfg = JRC(method="bin", tile_h=TH, tile_w=TW, bin_chunk=CHUNK,
              with_stats=True, bin_esub=esub)
    hit, stats = intersect_binned(o, None, jtris, jproj, cfg, RES_H, RES_W)
    e_cap = -(-(int(jtris.p1.shape[0] * cfg.bin_e_factor) + 8192) // CHUNK)
    i_cap = e_cap + (RES_H // TH) * (RES_W // TW)
    return hit, {k: np.asarray(v) for k, v in stats.items()}, i_cap


@pytest.mark.parametrize("esub", [1, 4])
def test_stats_match_jax(both, esub):
    jside, (ptris, pproj, o), _ = both
    jhit, js, i_cap = _jax_stats(jside, esub)
    with torch.no_grad():
        phit, ps = intersect_binned(o, None, ptris, pproj, _config(esub),
                                    RES_H, RES_W)
    ptri = phit.tri.numpy()
    assert (ptri >= 0).mean() > 0.5
    np.testing.assert_array_equal(ptri, np.asarray(jhit.tri))
    np.testing.assert_allclose(phit.t.numpy(), np.asarray(jhit.t), rtol=2e-6)
    steps, chunks = ps["steps"].numpy(), ps["chunks"].numpy()
    np.testing.assert_array_equal(steps, js["steps"])
    assert chunks.max() > 1                  # tiles of more than one block
    if esub > 1:                             # and some slices gated off
        assert steps.sum() < chunks.sum() * esub
    np.testing.assert_array_equal(chunks[:-1], js["chunks"][:-1])
    assert chunks[-1] == js["chunks"][-1] - (i_cap - chunks.sum())
    assert ps["entries"] == int(js["entries"])
    assert ps["overflow"] == 0 == int(js["overflow"])
    assert int(ps["cross"]) == int(js["cross"])


def test_stats_at_esub_1_leave_the_hits_bit_identical(both):
    _, (ptris, pproj, o), _ = both
    with torch.no_grad():
        hit, _ = intersect_binned(o, None, ptris, pproj, _config(1),
                                  RES_H, RES_W)
        plain = intersect_binned(o, None, ptris, pproj,
                                 _config(1, with_stats=False), RES_H, RES_W)
    assert torch.equal(hit.t, plain.t) and torch.equal(hit.tri, plain.tri)


def test_esub_degrades_as_in_jax():
    assert [effective_esub(512, e) for e in (1, 2, 4, 8)] == [1, 2, 4, 4]
    assert [effective_esub(128, e) for e in (1, 2, 4)] == [1, 1, 1]
    with pytest.raises(ValueError):
        effective_esub(512, 0)


def test_trace_rays_refuses_stats(both):
    from cpp_cuda_raytracer_dev_torch import Pose, Scene, SceneObject
    from cpp_cuda_raytracer_dev_torch.models.renderer import trace_rays
    _, (ptris, pproj, o), _ = both
    scene = Scene([SceneObject(ptris, Pose.identity(device="cpu"))])
    with pytest.raises(ValueError, match="with_stats"):
        trace_rays(scene, o, torch.zeros(RES_W * RES_H, 3), _config(1),
                   None, RES_H, RES_W, proj=pproj)


@pytest.mark.gpu
@pytest.mark.parametrize("esub", [1, 4])
def test_kernel_stats_match_plain_version_on_gpu(esub):
    """Bit for bit, steps included, and bitwise the same hits without the
    steps output (each switch setting is its own instantiation; at esub 1
    that is K1's walk over the own entries, which on this view gives the
    same hits)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    tris = Triangles.from_vertices(uv_sphere(50, 50, roughness=0.03),
                                   device="cuda")
    cam = Camera.create(RES_W, RES_H, pos=[0.1, 0.2, -2.2],
                        look_at=[0.0, 0.0, 0.0], up=[0.0, 1.0, 0.0],
                        film_h=0.024, focal=0.055, device="cuda")
    config = dataclasses.replace(_config(esub), backface_cull=True)
    with torch.no_grad():
        rays, b = bin_object(cam.pos, tris, cam.projection(), config,
                             RES_H, RES_W)
    ops = (rays, b.geom, b.entry_tri, b.starts, CHUNK)
    before = bin_intersect.launches
    kt, ktri, ksteps = bin_intersect(*ops, esub=esub, with_steps=True)
    torch.cuda.synchronize()
    assert bin_intersect.launches == before + 1
    rt, rtri, rsteps = bin_intersect_reference(*ops, esub=esub,
                                               with_steps=True)
    assert (rtri >= 0).float().mean() > 0.5
    assert torch.equal(ktri, rtri) and torch.equal(kt, rt)
    assert torch.equal(ksteps, rsteps)
    # without steps: K1's walk at esub 1, the sliced walk at esub 4
    pt, ptri = bin_intersect(*ops, esub=esub)
    wt, wtri = bin_intersect_reference(*ops, esub=esub)
    assert torch.equal(pt, wt) and torch.equal(ptri, wtri)
    assert torch.equal(pt, kt) and torch.equal(ptri, ktri)
