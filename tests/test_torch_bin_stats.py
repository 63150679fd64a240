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

The same comparison runs on a mesh whose every triangle is there twice
(ids i and i + n), so that every hit is an exact tie between two ids: the
within-slice rule (the lowest id at the minimum t) and the across-slice
rule (the best changes only on a strictly smaller t) decide every id.

On a CUDA device (``gpu`` marker, skipped here) the kernel equals its plain
version bit for bit at P 256 / 512 / 1024, esub 1 / 2 / 4 / 8, on the tie
mesh, at an infinite draw distance and with each design lever switched off.

The JAX package is imported inside the tests that use it, so that the GPU
tests also run where JAX is not installed:
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


def _sphere():
    return uv_sphere(50, 50, roughness=0.03)


def _tie_mesh():
    tv = uv_sphere(30, 30)
    return np.concatenate([tv, tv])


@pytest.fixture(scope="module")
def both():
    return _both(_sphere())


@pytest.fixture(scope="module")
def tie_both():
    return _both(_tie_mesh())


def _both(tv):
    import jax.numpy as jnp

    import cpp_cuda_raytracer_dev_tpu as J
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
    _assert_stats_match_jax(both, esub)


@pytest.mark.parametrize("esub", [1, 4])
def test_stats_match_jax_on_ties(tie_both, esub):
    """Every hit ties between triangles i and i + n; both packages take the
    same id on every ray, and the same counts. The copies sit side by side
    in the depth order, mostly in one slice, where the lower id wins."""
    tri = _assert_stats_match_jax(tie_both, esub)
    n = tie_both[2].shape[0] // 2
    assert (tri[tri >= 0] < n).mean() > 0.9


def _assert_stats_match_jax(sides, esub):
    jside, (ptris, pproj, o), _ = sides
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
    return ptri


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


@pytest.mark.parametrize("esub", [1, 4])
def test_walk_work_counts_the_aligned_walks_pairs(both, esub):
    """K3's bound reads its work from the plain walk: the entries of the
    slices whose gate opened (slices scanned x chunk / esub), and the pairs
    among them that the test accepted (at least one a hit ray)."""
    from cpp_cuda_raytracer_dev_torch.ops.cuda.bin_intersect import \
        walk_work
    _, (ptris, pproj, o), _ = both
    with torch.no_grad():
        rays, b = bin_object(o, ptris, pproj, _config(esub), RES_H, RES_W)
    ops = (rays, b.geom, b.entry_tri, b.starts, CHUNK)
    _, tri, steps = bin_intersect_reference(*ops, esub=esub, with_steps=True)
    entries, accepted = walk_work(*ops, esub=esub, own=False)
    assert torch.equal(entries, steps[:, 0].long() * (CHUNK // esub))
    p = rays.shape[1]
    assert bool(((tri >= 0).sum(dim=1) <= accepted).all())
    assert int(accepted.sum()) < int(entries.sum()) * p // 10
    own_entries, _ = walk_work(*ops)
    assert int(own_entries.sum()) < int(entries.sum())


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


# each design lever of K3 switched off: one ray a thread (R 1, one group of
# P threads at P 512), one entry group, two rays a thread in two groups,
# the next block copied only before its scan, the tiles in index order;
# and the CTA widened to eight groups (1,024 threads)
LEVERS = ({"rays_per_thread": 1}, {"groups": 1},
          {"rays_per_thread": 2, "groups": 2}, {"overlap": False},
          {"longest_first": False}, {"groups": 8})


def _gpu_operands(tv, tile=(TH, TW), pos=(0.1, 0.2, -2.2)):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda", 0)
    tris = Triangles.from_vertices(tv, device=dev)
    cam = Camera.create(RES_W, RES_H, pos=list(pos), look_at=[0.0, 0.0, 0.0],
                        up=[0.0, 1.0, 0.0], film_h=0.024, focal=0.055,
                        device=dev)
    config = RenderConfig(method="bin", tile_h=tile[0], tile_w=tile[1],
                          bin_chunk=CHUNK, backface_cull=True)
    with torch.no_grad():
        rays, b = bin_object(cam.pos, tris, cam.projection(), config, RES_H,
                             RES_W)
    return rays, b.geom, b.entry_tri, b.starts, CHUNK


def _assert_kernel_is_plain(ops, esub, with_steps, **kw):
    got = bin_intersect(*ops, esub=esub, with_steps=with_steps, **kw)
    torch.cuda.synchronize()
    want = bin_intersect_reference(*ops, esub=esub, with_steps=with_steps,
                                   **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want)), (esub, kw)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("esub", [1, 2, 4, 8])
@pytest.mark.parametrize("tile", [(16, 16), (16, 32), (32, 32)])
def test_kernel_matches_plain_version_at_each_width_on_gpu(tile, esub):
    """P 256 / 512 / 1024 rays a tile (4 rays a thread in 8 / 4 / 2 entry
    groups): t, tri and steps bit for bit, with the steps output and (K3's
    sliced instance, or K1's walk at esub 1) without."""
    ops = _gpu_operands(_sphere(), tile)
    for with_steps in (True, False):
        t, tri = _assert_kernel_is_plain(ops, esub, with_steps)[:2]
        assert (tri >= 0).float().mean() > 0.5


@pytest.mark.gpu
@pytest.mark.parametrize("esub", [1, 4])
def test_kernel_matches_plain_version_on_ties_gpu(esub):
    """Every hit an exact tie between ids i and i + n, which the entry
    groups' merge must settle as the plain version's rules do."""
    ops = _gpu_operands(_tie_mesh())
    for with_steps in (True, False):
        _assert_kernel_is_plain(ops, esub, with_steps)


@pytest.mark.gpu
@pytest.mark.parametrize("esub", [1, 4])
def test_kernel_at_infinite_draw_distance_on_gpu(esub):
    """Every entry takes part in the select, so a ray that hits nothing in
    a scanned slice takes its lowest id at t 3e38; the far view leaves such
    rays."""
    ops = _gpu_operands(_sphere(), pos=(0.1, 0.2, -6.0))
    t, tri, _ = _assert_kernel_is_plain(ops, esub, True,
                                        draw_distance=float("inf"))
    assert bool(((t == 3.0e38) & (tri >= 0)).any())


@pytest.mark.gpu
@pytest.mark.parametrize("lever", range(len(LEVERS)))
def test_levers_off_give_the_design_result_on_gpu(lever):
    from cpp_cuda_raytracer_dev_torch.ops.cuda import bin_intersect as k1
    ops = _gpu_operands(_sphere())
    for esub, with_steps in ((1, True), (4, True), (4, False)):
        want = bin_intersect(*ops, esub=esub, with_steps=with_steps)
        got = k1._launch(*ops, k1.MT_EPSILON, k1.DEFAULT_DRAW_DISTANCE, esub,
                         with_steps, **LEVERS[lever])
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want)), esub
