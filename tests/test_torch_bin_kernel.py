"""The bin-intersect kernel's plain version vs the JAX package's Pallas
kernel K1 (``pallas_bin_intersect3`` in interpret mode), the port's walk
over each tile's own entries vs the JAX kernels' walk over whole blocks
(ROADMAP F9), and the kernel vs its plain version on the card.

Both sides get identical binned inputs: the JAX package's ray table and
entry table (its 12th row, the id in float32, is the port's int32
``entry_tri``). Tolerances: the winning ids are equal; t at rtol 2e-6. The
plain version rounds every product, as the CUDA kernel built with
-fmad=false does, while XLA on the CPU fuses a·b + c·d into multiply-adds;
near-grazing hits cancel in det and the two land up to 11 float32 ulps
apart (1.08e-6 relative, measured on these inputs).

The JAX package is imported inside the tests that use it, so that the GPU
tests also run where JAX is not installed:
    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_bin_kernel.py
"""

import numpy as np
import pytest
import torch

from cpp_cuda_raytracer_dev_torch import Camera, RenderConfig, Triangles
from cpp_cuda_raytracer_dev_torch.accel.traverse import bin_object
from cpp_cuda_raytracer_dev_torch.ops.cuda.bin_intersect import (
    bin_intersect, bin_intersect_reference, walk_work)
from cpp_cuda_raytracer_dev_torch.utils.procgen import (dragon_class_mesh,
                                                        uv_sphere)

RES_W, RES_H, TH, TW = 96, 64, 16, 32
N_TILES = (RES_W // TW) * (RES_H // TH)


def _jax_operands(cull, chunk):
    import jax.numpy as jnp

    import cpp_cuda_raytracer_dev_tpu as J
    from cpp_cuda_raytracer_dev_tpu.accel.binning import bin_triangles
    from cpp_cuda_raytracer_dev_tpu.accel.traverse import _ray_table

    tv = uv_sphere(50, 50, roughness=0.03)
    tris = J.Triangles.from_vertices(tv)
    cam = J.Camera.create(RES_W, RES_H, pos=[0.0, 0.2, -3.0],
                          look_at=[0.0, 0.0, 0.0], up=[0.0, 1.0, 0.0],
                          film_h=0.024, focal=0.055)
    proj = cam.projection()
    v = tv.reshape(-1, 3)
    rays = _ray_table(proj, cam.pos, jnp.asarray(v.min(0)),
                      jnp.asarray(v.max(0)), N_TILES, RES_W // TW, TH, TW,
                      400.0)
    binned = bin_triangles(proj, cam.pos, tris.p1, tris.e1, tris.e2, RES_H,
                           RES_W, TH, TW, e_cap=131072, chunk=chunk,
                           backface_cull=cull)
    return rays, binned


def _port_operands(rays, binned):
    def t(x):
        return torch.tensor(np.asarray(x))
    return (t(rays), t(np.asarray(binned.geom)[:11]), t(binned.entry_tri),
            t(binned.starts))


@pytest.mark.parametrize("cull,chunk", [(False, 128), (True, 128),
                                        (False, 64)])
def test_plain_version_matches_jax_kernel(cull, chunk):
    from cpp_cuda_raytracer_dev_tpu.ops.pallas.bin_kernel3 import (
        pallas_bin_intersect3)

    rays, binned = _jax_operands(cull, chunk)
    jt, jtri = pallas_bin_intersect3(
        binned.item_tile, binned.item_block, rays, binned.geom,
        n_tiles=N_TILES, p=TH * TW, n_items=binned.item_tile.shape[0],
        chunk=chunk, interpret=True)
    pt, ptri = bin_intersect_reference(*_port_operands(rays, binned), chunk)
    assert ptri.dtype == torch.int32 and pt.shape == (N_TILES, TH * TW)
    assert (ptri >= 0).float().mean() > 0.5
    np.testing.assert_array_equal(ptri.numpy(), np.asarray(jtri))
    np.testing.assert_allclose(pt.numpy(), np.asarray(jt), rtol=2e-6)


def _port_binned(tv, res_w, res_h, cull, chunk, device, tile=(TH, TW),
                 pos=(0.0, 0.2, -3.0)):
    tris = Triangles.from_vertices(tv, device=device)
    cam = Camera.create(res_w, res_h, pos=list(pos), look_at=[0.0, 0.0, 0.0],
                        up=[0.0, 1.0, 0.0], film_h=0.024, focal=0.055,
                        device=device)
    config = RenderConfig(method="bin", tile_h=tile[0], tile_w=tile[1],
                          bin_chunk=chunk, backface_cull=cull)
    with torch.no_grad():
        rays, b = bin_object(cam.pos, tris, cam.projection(), config,
                             res_h, res_w)
    return rays, b.geom, b.entry_tri, b.starts


@pytest.mark.parametrize("mesh,res,cull,pos", [
    ("sphere", (RES_W, RES_H), False, (0.0, 0.2, -3.0)),
    ("sphere", (RES_W, RES_H), True, (0.0, 0.2, -3.0)),
    ("dragon-class 20k", (240, 136), True, (0.0, 0.0, -3.0))])
def test_own_range_walk_matches_aligned_walk(mesh, res, cull, pos):
    """Binning is conservative, so the other tiles' entries that share a
    tile's first and last block cannot hit its rays: K1's walk over the own
    entries gives the same t bit for bit and the same ids as K3's walk over
    whole blocks (K3 at esub 1), while it scans fewer entries."""
    tv = (uv_sphere(50, 50, roughness=0.03) if mesh == "sphere"
          else dragon_class_mesh(20_000))
    ops = _port_binned(tv, *res, cull, 512, "cpu", pos=pos)
    own_t, own_tri = bin_intersect_reference(*ops, 512)
    al_t, al_tri, steps = bin_intersect_reference(*ops, 512, with_steps=True)
    assert (own_tri >= 0).float().mean() > 0.3
    assert torch.equal(own_t, al_t)
    assert torch.equal(own_tri, al_tri)
    own_entries, accepted = walk_work(*ops, 512)
    assert (int(own_entries.sum()) * ops[0].shape[1]
            < int(steps[:, 0].sum()) * 512 * ops[0].shape[1])
    # every hit was accepted; the test accepts few of the pairs
    assert (int((own_tri >= 0).sum()) <= int(accepted.sum())
            < int(own_entries.sum()) * ops[0].shape[1] // 10)


def test_wrapper_runs_plain_version_for_cpu_tensors():
    rays, binned = _jax_operands(False, 128)
    ops = _port_operands(rays, binned)
    before = bin_intersect.launches
    t, tri = bin_intersect(*ops, 128)
    rt, rtri = bin_intersect_reference(*ops, 128)
    assert torch.equal(t, rt) and torch.equal(tri, rtri)
    assert bin_intersect.launches == before        # no kernel launched


def test_wrapper_rejects_bad_operands():
    rays, binned = _jax_operands(False, 128)
    r, g, e, s = _port_operands(rays, binned)
    with pytest.raises(ValueError, match="power of two"):
        bin_intersect(r, g, e, s, 96)
    with pytest.raises(ValueError, match="geom"):
        bin_intersect(r, g[:, :-1], e, s, 128)
    with pytest.raises(ValueError, match="entry_tri"):
        bin_intersect(r, g, e.long(), s, 128)
    with pytest.raises(ValueError, match="starts"):
        bin_intersect(r, g, e, s[:-1], 128)
    with pytest.raises(ValueError, match="contiguous"):
        bin_intersect(r, g.T.contiguous().T, e, s, 128)


@pytest.mark.gpu
@pytest.mark.parametrize("cull", [False, True])
def test_kernel_matches_plain_version_on_gpu(cull):
    """Bit for bit: same blocks in the same order, same float32 roundings."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    tris = Triangles.from_vertices(uv_sphere(50, 50, roughness=0.03),
                                   device="cuda")
    cam = Camera.create(RES_W, RES_H, pos=[0.0, 0.2, -3.0],
                        look_at=[0.0, 0.0, 0.0], up=[0.0, 1.0, 0.0],
                        film_h=0.024, focal=0.055, device="cuda")
    config = RenderConfig(method="bin", tile_h=TH, tile_w=TW, bin_chunk=128,
                          backface_cull=cull)
    with torch.no_grad():
        rays, b = bin_object(cam.pos, tris, cam.projection(), config,
                             RES_H, RES_W)
    before = bin_intersect.launches
    kt, ktri = bin_intersect(rays, b.geom, b.entry_tri, b.starts, 128)
    torch.cuda.synchronize()
    assert bin_intersect.launches == before + 1
    rt, rtri = bin_intersect_reference(rays, b.geom, b.entry_tri, b.starts,
                                       128)
    assert (rtri >= 0).float().mean() > 0.5
    assert torch.equal(ktri, rtri)
    assert torch.equal(kt, rt)


@pytest.mark.gpu
@pytest.mark.parametrize("tile,chunk,draw", [
    ((16, 32), 512, 400.0), ((8, 32), 128, 400.0), ((32, 32), 512, 400.0),
    ((4, 8), 128, 400.0), ((8, 12), 64, 400.0), ((16, 32), 128, np.inf)])
def test_kernel_shapes_match_plain_version_on_gpu(tile, chunk, draw):
    """Bit for bit at every CTA shape the wrapper picks (4, 2 and 1 rays a
    thread, 1-16 entry groups) and with an infinite draw distance, where
    rejected entries take part in the select; the tiles longest first and
    in index order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    ops = _port_binned(dragon_class_mesh(20_000), 240, 136, True, chunk,
                       "cuda", tile=tile, pos=(0.3, 0.1, -2.5))
    before = bin_intersect.launches
    kt, ktri = bin_intersect(*ops, chunk, draw_distance=draw)
    torch.cuda.synchronize()
    nt, ntri = bin_intersect(*ops, chunk, draw_distance=draw,
                             longest_first=False)
    torch.cuda.synchronize()
    assert bin_intersect.launches == before + 2
    rt, rtri = bin_intersect_reference(*ops, chunk, draw_distance=draw)
    assert (rtri >= 0).float().mean() > 0.3
    for t, tri in ((kt, ktri), (nt, ntri)):
        assert torch.equal(tri, rtri)
        assert torch.equal(t, rt)
