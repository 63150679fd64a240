"""The bin path's prepass, kernels K8 and K9 (``ops/cuda/bin_prepass.py``):
the per-triangle pass, the ray table and the entry passes around the key
sort.

On the CPU:
- the plain versions the prepass is split into (`bin_tri_pass_reference`,
  ``_ray_table``, `bin_entry_keys_reference`, `bin_entry_table_reference`)
  compose bitwise to the unsplit prepass (`_unsplit_bin_object` below, the
  code they were cut from): ``geom``, ``entry_tri``, ``starts``,
  ``num_entries``, ``qstep``, ``cross_tris`` and the ray table, at the live
  count and at a capacity bucket (and one below the live count), with and
  without backface cull, with a camera-plane crosser, for a band of rows
  (``row0`` > 0) and a posed object; an object with no triangles and a
  frame with no live entry give empty tables;
- the port's ray table and binning against the JAX package's
  ``_ray_table`` and ``bin_triangles`` on the same numpy inputs: rays at
  rtol 2e-6 (XLA fuses multiply-adds, PyTorch rounds each product); the
  entry count, starts and ids exactly, the MT rows at rtol 1e-6, as
  tests/test_torch_binning.py;
- the wrappers run the plain versions for CPU tensors (no launch counted)
  and refuse operands the kernels do not take.

On the card (marked ``gpu``; they skip here): each kernel bitwise its
plain version on the same cases, and ``render_jit`` bitwise ``render``
with the K8, K9 and K10 counters moving. The JAX package is imported
inside the CPU tests, so that the GPU tests run where JAX is not
installed:
    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_bin_prepass.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from cpp_cuda_raytracer_dev_torch import (Camera, Pose, RenderConfig, Scene,
                                          SceneObject, Triangles)
from cpp_cuda_raytracer_dev_torch.accel.traverse import (_bin_meta,
                                                         _ray_table,
                                                         bin_object)
from cpp_cuda_raytracer_dev_torch.ops.cuda import bin_prepass as bp
from cpp_cuda_raytracer_dev_torch.ops.quaternion import from_axis_angle
from cpp_cuda_raytracer_dev_torch.utils.procgen import (dragon_class_mesh,
                                                        uv_sphere)

RES_W, RES_H, TH, TW, CHUNK = 96, 64, 16, 32, 128
FIELDS = ("geom", "entry_tri", "starts", "qstep", "cross_tris")
# name: (mesh, camera position, cull, capacity, row0, posed)
CASES = {
    "sphere": ("sphere", (0.1, 0.2, -3.0), False, None, 0, False),
    "sphere cull": ("sphere", (0.1, 0.2, -3.0), True, None, 0, False),
    "sphere bucket": ("sphere", (0.1, 0.2, -3.0), False, 4096, 0, False),
    "sphere cull bucket": ("sphere", (0.1, 0.2, -3.0), True, 4096, 0,
                           False),
    "bucket below the live count": ("sphere", (0.1, 0.2, -3.0), False, 256,
                                    0, False),
    "camera-plane crosser": ("crosser", (0.0, 0.0, 0.0), False, None, 0,
                             False),
    "band": ("dragon", (0.3, 0.1, -2.5), True, None, 32, False),
    "band bucket": ("dragon", (0.3, 0.1, -2.5), True, 8192, 16, False),
    "posed": ("sphere", (0.1, 0.2, -3.0), True, None, 0, True),
    "no triangles": ("empty", (0.1, 0.2, -3.0), False, None, 0, False),
    "no triangles bucket": ("empty", (0.1, 0.2, -3.0), False, 512, 0,
                            False),
    "no live entry": ("sphere", (0.0, 0.0, 3.0), False, None, 0, False),
    "no live entry bucket": ("sphere", (0.0, 0.0, 3.0), False, 512, 0,
                             False),
}


def _mesh(name):
    if name == "sphere":
        return uv_sphere(30, 30, roughness=0.03)
    if name == "dragon":
        return dragon_class_mesh(5_000)
    if name == "empty":
        return np.zeros((0, 3, 3), np.float32)
    # a sphere in front of the camera, and a triangle through its plane
    tv = uv_sphere(20, 20) * 0.5 + np.array([0.0, 0.0, 3.0], np.float32)
    cross = np.array([[[0.0, -0.5, -1.0], [0.5, 0.5, 8.0],
                       [-0.5, 0.5, 8.0]]], np.float32)
    return np.concatenate([tv, cross])


def _setup(case, device):
    """(object-frame origin, Triangles, band Projection, config, band
    height, capacity) of a case; the camera looks at the origin, or along
    +z from the origin for the crosser (whose look_at is (0, 0, 1))."""
    mesh, pos, cull, capacity, row0, posed = CASES[case]
    tris = Triangles.from_vertices(_mesh(mesh), device=device)
    look = [0.0, 0.0, 1.0] if mesh == "crosser" else [0.0, 0.0, 0.0]
    if case.startswith("no live entry"):
        look = [0.0, 0.0, 6.0]          # looking away from the mesh
    cam = Camera.create(RES_W, RES_H, pos=list(pos), look_at=look,
                        up=[0.0, 1.0, 0.0], film_h=0.024, focal=0.055,
                        device=device)
    pose = (Pose(from_axis_angle([0.3, 1.0, 0.1], 0.6, device=device),
                 torch.tensor([0.15, -0.1, 0.2], device=device))
            if posed else Pose.identity(device=device))
    proj = dataclasses.replace(cam.projection().transformed(pose), row0=row0)
    config = RenderConfig(method="bin", tile_h=TH, tile_w=TW,
                          bin_chunk=CHUNK, backface_cull=cull)
    return pose.inv_apply(cam.pos), tris, proj, config, RES_H - row0, capacity


def _leaves(tris):
    return ((tris.p1x, tris.p1y, tris.p1z), (tris.e1x, tris.e1y, tris.e1z),
            (tris.e2x, tris.e2y, tris.e2z))


def _unsplit_bin_object(o, tris, proj, config, res_h, res_w, capacity):
    """The prepass before it was split at the kernels' boundaries:
    ``bin_object``'s root box and ray table, and ``bin_triangles`` in one
    piece (the code the plain versions were cut from)."""
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    dev = o.device
    h2, w2, th, tw = _bin_meta(config, res_h, res_w)[:4]
    n_tx, chunk, eps = w2 // tw, config.bin_chunk, config.eps
    n_tiles = (h2 // th) * n_tx
    (p1x, p1y, p1z), (e1x, e1y, e1z), (e2x, e2y, e2z) = _leaves(tris)
    bmin, bmax = [], []
    for v1, d1, d2 in ((p1x, e1x, e2x), (p1y, e1y, e2y), (p1z, e1z, e2z)):
        v2, v3 = v1 + d1, v1 + d2
        bmin.append(torch.minimum(torch.minimum(v1, v2), v3).amin())
        bmax.append(torch.maximum(torch.maximum(v1, v2), v3).amax())
    rays = _ray_table(proj, o, bmin, bmax, n_tiles, n_tx, th, tw,
                      config.draw_distance)
    proj = proj.band_local()
    t_n = p1x.shape[0]
    q0x, q0y, q0z = (p1x - proj.origin[0], p1y - proj.origin[1],
                     p1z - proj.origin[2])

    def dotb(vx, vy, vz, b):
        return vx * b[0] + vy * b[1] + vz * b[2]
    a0, b0, c0 = (dotb(q0x, q0y, q0z, b) for b in (proj.n, proj.u, proj.v))
    a1, b1, c1 = (x + dotb(e1x, e1y, e1z, b)
                  for x, b in ((a0, proj.n), (b0, proj.u), (c0, proj.v)))
    a2, b2, c2 = (x + dotb(e2x, e2y, e2z, b)
                  for x, b in ((a0, proj.n), (b0, proj.u), (c0, proj.v)))
    f0, f1, f2 = a0 > 0.0, a1 > 0.0, a2 > 0.0
    any_front = f0 | f1 | f2
    cross = any_front & ~(f0 & f1 & f2)
    if config.backface_cull:
        nx = e1y * e2z - e1z * e2y
        ny = e1z * e2x - e1x * e2z
        nz = e1x * e2y - e1y * e2x
        away = (nx * (p1x - o[0]) + ny * (p1y - o[1])
                + nz * (p1z - o[2])) > 0.0
        cross, any_front = cross & ~away, any_front & ~away

    def px(b, a):
        return proj.adjust_x + proj.sx * (b / torch.clamp_min(a, 1e-20))

    def py(c, a):
        return proj.adjust_y + proj.sy * (c / torch.clamp_min(a, 1e-20))
    pxs, pys = (px(b0, a0), px(b1, a1), px(b2, a2)), (py(c0, a0), py(c1, a1),
                                                     py(c2, a2))
    x0 = torch.minimum(torch.minimum(pxs[0], pxs[1]), pxs[2]) - 0.5
    x1 = torch.maximum(torch.maximum(pxs[0], pxs[1]), pxs[2]) + 0.5
    y0 = torch.minimum(torch.minimum(pys[0], pys[1]), pys[2]) - 0.5
    y1 = torch.maximum(torch.maximum(pys[0], pys[1]), pys[2]) + 0.5
    x0, y0 = torch.where(cross, 0.0, x0), torch.where(cross, 0.0, y0)
    x1 = torch.where(cross, float(w2 - 1), x1)
    y1 = torch.where(cross, float(h2 - 1), y1)
    ix0 = torch.clamp(torch.ceil(x0), 0, w2 - 1).to(i64)
    ix1 = torch.floor(torch.clamp(x1, 0, w2 - 1)).to(i64)
    iy0 = torch.clamp(torch.ceil(y0), 0, h2 - 1).to(i64)
    iy1 = torch.floor(torch.clamp(y1, 0, h2 - 1)).to(i64)
    onscreen = (any_front & (x1 >= 0) & (x0 <= w2 - 1) & (y1 >= 0)
                & (y0 <= h2 - 1) & (ix1 >= ix0) & (iy1 >= iy0))
    tx0, ty0 = ix0 // tw, iy0 // th
    ntx = torch.where(onscreen, ix1 // tw - tx0 + 1, 0)
    nty = torch.where(onscreen, iy1 // th - ty0 + 1, 0)
    cum = torch.cumsum(ntx * nty, dim=0)
    if capacity is None:
        n_e = size = int(cum[-1])
    else:
        n_e, size = cum[-1], capacity
    j = torch.arange(size, dtype=i64, device=dev)
    tri_j = torch.searchsorted(cum, j, right=True)
    dbits = 31 - n_tiles.bit_length()
    dmax = (1 << dbits) - 1
    big = 3.0e38
    depth = torch.minimum(torch.minimum(torch.where(f0, a0, big),
                                        torch.where(f1, a1, big)),
                          torch.where(f2, a2, big))
    depth = torch.where(cross, 0.0, torch.clamp_min(depth, 0.0))
    d_lo = torch.where(onscreen, depth, big).amin()
    d_hi = torch.where(onscreen & torch.isfinite(depth), depth, 0.0).amax()
    d_rng = torch.clamp_min(d_hi - d_lo, 1e-20)
    dmax_f = torch.full_like(d_rng, float(dmax))
    dq = torch.clamp(torch.clamp_min((depth - d_lo) * (dmax_f / d_rng), 0.0),
                     max=float(dmax)).to(i64).clamp_(max=dmax)
    itab = torch.stack([cum, ntx * nty, ntx, tx0, ty0, dq], dim=1)
    if capacity is not None:
        itab = torch.cat([itab, itab.new_zeros((1, 6))])
    ient = itab.index_select(0, tri_j)
    si = j - ient[:, 0] + ient[:, 1]
    ntx_j = torch.clamp_min(ient[:, 2], 1)
    tile_j = (ient[:, 4] + si // ntx_j) * n_tx + ient[:, 3] + si % ntx_j
    key = ((tile_j << dbits) | ient[:, 5]).to(i32)
    if capacity is not None:
        key = torch.where(tri_j < t_n, key, (n_tiles << dbits) | dmax)
    key, order = torch.sort(key, stable=True)
    tri_sorted = tri_j.index_select(0, order)
    tile_keys = torch.arange(n_tiles + 1, dtype=i64, device=dev) << dbits
    starts = torch.searchsorted(key, tile_keys.to(i32)).to(i32)
    tvx, tvy, tvz = o[0] - p1x, o[1] - p1y, o[2] - p1z
    md = (e2y * e1z - e2z * e1y, e2z * e1x - e2x * e1z,
          e2x * e1y - e2y * e1x)
    mu = (e2y * tvz - e2z * tvy, e2z * tvx - e2x * tvz,
          e2x * tvy - e2y * tvx)
    mv = (tvy * e1z - tvz * e1y, tvz * e1x - tvx * e1z,
          tvx * e1y - tvy * e1x)
    td = e2x * mv[0] + e2y * mv[1] + e2z * mv[2]
    k1 = float(torch.tensor(1.0 - eps, dtype=f32))
    eps_f = float(torch.tensor(eps, dtype=f32))
    ftab = torch.stack([*(k1 * m for m in md),
                        *(a - eps_f * m for a, m in zip(mu, md)),
                        *(a - eps_f * m for a, m in zip(mv, md)),
                        k1 * td, depth], dim=1)
    e_pad = -(-size // chunk) * chunk + chunk
    dead = torch.zeros((e_pad - size, 11), dtype=f32, device=dev)
    dead[:, 10] = big
    ids = tri_sorted.to(i32)
    if capacity is not None:
        ftab = torch.cat([ftab, dead[:1]])
        ids = torch.where(tri_sorted < t_n, ids, -1)
    geom = torch.cat([ftab.index_select(0, tri_sorted), dead]).T.contiguous()
    entry_tri = torch.cat([ids, torch.full((e_pad - size,), -1, dtype=i32,
                                           device=dev)])
    return rays, dict(geom=geom, entry_tri=entry_tri, starts=starts,
                      qstep=d_rng / dmax_f, cross_tris=cross.sum(),
                      num_entries=n_e)


def _bin(case, device):
    o, tris, proj, config, res_h, cap = _setup(case, device)
    with torch.no_grad():
        return bin_object(o, tris, proj, config, res_h, RES_W, cap)


@pytest.mark.parametrize("case", [c for c in CASES if "no triangles" not in c])
def test_plain_versions_compose_to_the_unsplit_prepass(case):
    o, tris, proj, config, res_h, cap = _setup(case, "cpu")
    rays, b = _bin(case, "cpu")
    ref_rays, ref = _unsplit_bin_object(o, tris, proj, config, res_h, RES_W,
                                        cap)
    assert torch.equal(rays, ref_rays)
    for f in FIELDS:
        assert torch.equal(getattr(b, f), ref[f]), f
    assert int(b.num_entries) == int(ref["num_entries"])
    live = int(b.num_entries)
    if case == "bucket below the live count":
        assert live > cap
    elif case.startswith("no live entry"):
        assert live == 0 and (b.entry_tri == -1).all()
        assert (b.starts == 0).all()
    else:
        assert live > 0 and (b.entry_tri[:live] >= 0).all()
    if case == "camera-plane crosser":
        assert int(b.cross_tris) == 1
    if cap is not None:
        assert b.entry_tri.shape[0] == cap + CHUNK
        assert int(b.starts[-1]) == min(live, cap)


@pytest.mark.parametrize("case", ["no triangles", "no triangles bucket"])
def test_no_triangles_bins_nothing(case):
    """``amin`` refuses an empty tensor, so the unsplit prepass raised on an
    object with no triangles; the split one gives an empty table, the
    reductions' identities as root box and depth range, and rays bounded by
    the draw distance (no entry can hit them)."""
    rays, b = _bin(case, "cpu")
    cap = CASES[case][3]
    assert int(b.num_entries) == 0 and int(b.cross_tris) == 0
    assert (b.entry_tri == -1).all() and (b.starts == 0).all()
    assert b.entry_tri.shape[0] == (cap or 0) + CHUNK
    assert (b.geom[:10] == 0).all() and (b.geom[10] == bp.BIG).all()
    inf = float("inf")
    assert b.bounds.tolist() == [inf, inf, inf, -inf, -inf, -inf]
    assert rays.shape == (12, TH * TW, 4) and torch.isfinite(rays).all()
    assert (rays[..., 3] == 400.0).all()


def test_ray_table_and_binning_match_jax():
    import jax.numpy as jnp

    import cpp_cuda_raytracer_dev_tpu as J
    from cpp_cuda_raytracer_dev_tpu.accel.binning import \
        bin_triangles as jbin
    from cpp_cuda_raytracer_dev_tpu.accel.traverse import \
        _ray_table as jray_table
    from cpp_cuda_raytracer_dev_tpu.ops.quaternion import Pose as JPose
    from cpp_cuda_raytracer_dev_tpu.ops.quaternion import \
        from_axis_angle as jaxis
    from cpp_cuda_raytracer_dev_torch.models.camera import Projection

    tv = uv_sphere(30, 30, roughness=0.03)
    jt = J.Triangles.from_vertices(tv)
    cam = J.Camera.create(RES_W, RES_H, pos=[0.1, 0.2, -3.0],
                          look_at=[0.0, 0.0, 0.0], up=[0.0, 1.0, 0.0],
                          film_h=0.024, focal=0.055)
    pose = JPose(quat=jaxis(jnp.array([0.3, 1.0, 0.1]), 0.6),
                 translation=jnp.array([0.15, -0.1, 0.2]))
    jproj, o = cam.projection().transformed(pose), pose.inv_apply(cam.pos)
    v = np.asarray(tv).reshape(-1, 3)
    n_tiles = (RES_W // TW) * (RES_H // TH)
    jrays = jray_table(jproj, o, jnp.asarray(v.min(0)), jnp.asarray(v.max(0)),
                       n_tiles, RES_W // TW, TH, TW, 400.0)
    jb = jbin(jproj, o, jt.p1, jt.e1, jt.e2, RES_H, RES_W, TH, TW,
              e_cap=131072, chunk=CHUNK, backface_cull=True)
    proj = Projection(**{f: torch.tensor(np.asarray(getattr(jproj, f)))
                         for f in ("origin", "n", "u", "v", "sx", "sy",
                                   "adjust_x", "adjust_y")})
    tris = Triangles.from_vertices(tv, device="cpu")
    config = RenderConfig(method="bin", tile_h=TH, tile_w=TW,
                          bin_chunk=CHUNK, backface_cull=True)
    with torch.no_grad():
        rays, b = bin_object(torch.tensor(np.asarray(o)), tris, proj, config,
                             RES_H, RES_W)
    np.testing.assert_allclose(rays.numpy(), np.asarray(jrays), rtol=2e-6,
                               atol=1e-7)
    e = int(jb.num_entries)
    assert b.num_entries == e > 200
    np.testing.assert_array_equal(b.starts.numpy(), np.asarray(jb.starts))
    np.testing.assert_array_equal(b.entry_tri[:e].numpy(),
                                  np.asarray(jb.entry_tri)[:e])
    np.testing.assert_allclose(b.geom[:, :e].numpy(),
                               np.asarray(jb.geom)[:11, :e], rtol=1e-6)
    assert int(b.cross_tris) == int(jb.cross_tris)


def test_wrappers_run_plain_versions_for_cpu_tensors():
    o, tris, proj, config, res_h, _ = _setup("sphere cull bucket", "cpu")
    counters = (bp.bin_tri_pass, bp.ray_table, bp.bin_entry_keys,
                bp.bin_entry_table)
    before = [f.launches for f in counters]
    args = (proj, o, *_leaves(tris), res_h, RES_W, TH, TW, config.eps, True)
    tp, ref = bp.bin_tri_pass(*args), bp.bin_tri_pass_reference(*args)
    for f in ("ntiles", "tinfo", "ftab", "stats", "cross_tris"):
        assert torch.equal(getattr(tp, f), getattr(ref, f)), f
    cum = torch.cumsum(tp.ntiles, 0)
    keys = bp.bin_entry_keys(cum, tp, 12, 3, 4096, 27)
    for a, r in zip(keys, bp.bin_entry_keys_reference(cum, tp, 12, 3,
                                                      4096, 27)):
        assert torch.equal(a, r)
    key, order = torch.sort(keys[0], stable=True)
    table = bp.bin_entry_table(key, order, keys[1], tp.ftab, 12, 27,
                               4096 + CHUNK)
    for a, r in zip(table, bp.bin_entry_table_reference(
            key, order, keys[1], tp.ftab, 12, 27, 4096 + CHUNK)):
        assert torch.equal(a, r)
    assert torch.equal(
        bp.ray_table(proj, o, tp.stats, 12, 3, TH, TW, 400.0),
        _ray_table(proj, o, tp.stats[:3], tp.stats[3:6], 12, 3, TH, TW,
                   400.0))
    assert [f.launches for f in counters] == before   # no kernel launched


def test_wrappers_reject_bad_operands():
    o, tris, proj, config, res_h, _ = _setup("sphere", "cpu")
    leaves = _leaves(tris)
    with pytest.raises(ValueError, match="float32"):
        bp.bin_tri_pass(proj, o, tuple(x.double() for x in leaves[0]),
                        *leaves[1:], res_h, RES_W, TH, TW, 1e-7, False)
    with pytest.raises(ValueError, match="origin"):
        bp.bin_tri_pass(proj, o[:2], *leaves, res_h, RES_W, TH, TW, 1e-7,
                        False)
    with pytest.raises(ValueError, match="bad image"):
        bp.bin_tri_pass(proj, o, *leaves, res_h, RES_W, 0, TW, 1e-7, False)
    tp = bp.bin_tri_pass(proj, o, *leaves, res_h, RES_W, TH, TW, 1e-7,
                         False)
    cum = torch.cumsum(tp.ntiles, 0)
    with pytest.raises(ValueError, match="cum"):
        bp.bin_entry_keys(cum.int(), tp, 12, 3, 64, 27)
    with pytest.raises(ValueError, match="dbits"):
        bp.bin_entry_keys(cum, tp, 12, 3, 64, 31)
    with pytest.raises(ValueError, match="tinfo"):
        bp.bin_entry_keys(cum, dataclasses.replace(tp, tinfo=tp.tinfo.long()),
                          12, 3, 64, 27)
    key, tri, _ = bp.bin_entry_keys(cum, tp, 12, 3, 64, 27)
    key, order = torch.sort(key, stable=True)
    with pytest.raises(ValueError, match="order"):
        bp.bin_entry_table(key, order.int(), tri, tp.ftab, 12, 27, 192)
    with pytest.raises(ValueError, match="e_pad"):
        bp.bin_entry_table(key, order, tri, tp.ftab, 12, 27, 64)
    with pytest.raises(ValueError, match="bounds"):
        bp.ray_table(proj, o, tp.stats.double(), 12, 3, TH, TW, 400.0)


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_kernels_match_plain_versions_on_gpu(case):
    """K8 (both launches), K9a and K9b bit for bit against their plain
    versions on the same operands."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    o, tris, proj, config, res_h, cap = _setup(case, "cuda")
    h2, w2 = _bin_meta(config, res_h, RES_W)[:2]
    n_tx, n_tiles = w2 // TW, (h2 // TH) * (w2 // TW)
    dbits = 31 - n_tiles.bit_length()
    counters = (bp.bin_tri_pass, bp.ray_table, bp.bin_entry_keys,
                bp.bin_entry_table)
    before = [f.launches for f in counters]
    with torch.no_grad():
        args = (proj.band_local(), o, *_leaves(tris), h2, w2, TH, TW,
                config.eps, config.backface_cull)
        tp, tr = bp.bin_tri_pass(*args), bp.bin_tri_pass_reference(*args)
        for f in ("ntiles", "tinfo", "ftab", "stats", "cross_tris"):
            assert torch.equal(getattr(tp, f), getattr(tr, f)), f
        rays = bp.ray_table(proj, o, tp.stats, n_tiles, n_tx, TH, TW, 400.0)
        assert torch.equal(rays, _ray_table(proj, o, tp.stats[:3],
                                            tp.stats[3:6], n_tiles, n_tx,
                                            TH, TW, 400.0))
        cum = torch.cumsum(tp.ntiles, 0)
        size = cap if cap is not None else (int(cum[-1]) if len(cum) else 0)
        keys = bp.bin_entry_keys(cum, tp, n_tiles, n_tx, size, dbits)
        for a, r in zip(keys, bp.bin_entry_keys_reference(
                cum, tp, n_tiles, n_tx, size, dbits)):
            assert torch.equal(a, r)
        key, order = torch.sort(keys[0], stable=True)
        e_pad = -(-size // CHUNK) * CHUNK + CHUNK
        table = bp.bin_entry_table(key, order, keys[1], tp.ftab, n_tiles,
                                   dbits, e_pad)
        for a, r in zip(table, bp.bin_entry_table_reference(
                key, order, keys[1], tp.ftab, n_tiles, dbits, e_pad)):
            assert torch.equal(a, r)
    torch.cuda.synchronize()
    assert [f.launches for f in counters] == [b + 1 for b in before]


@pytest.mark.gpu
def test_render_jit_matches_render_with_the_kernels_on_gpu():
    """A replayed bin frame of two posed objects bitwise `render`'s, with
    K8, K9 and K10 launched (by the capture) and the eager frame."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from cpp_cuda_raytracer_dev_torch import render, render_jit
    from cpp_cuda_raytracer_dev_torch.ops.cuda import shade as k10
    tris = Triangles.from_vertices(dragon_class_mesh(5_000), device="cuda")
    poses = [Pose(from_axis_angle([0.0, 1.0, 0.0], a, device="cuda"),
                  torch.tensor(t, device="cuda"))
             for a, t in ((0.3, [-0.5, 0.0, 0.0]), (-0.4, [0.6, 0.1, 0.3]))]
    scene = Scene([SceneObject(tris, p) for p in poses])
    cam = Camera.create(RES_W, RES_H, pos=[0.1, 0.2, -3.0],
                        look_at=[0.0, 0.0, 0.0], up=[0.0, 1.0, 0.0],
                        film_h=0.024, focal=0.055, device="cuda")
    config = RenderConfig(method="bin", tile_h=TH, tile_w=TW,
                          bin_chunk=CHUNK, backface_cull=True)
    counters = (bp.bin_tri_pass, bp.ray_table, bp.bin_entry_keys,
                bp.bin_entry_table, k10.shade_compose)
    before = [f.launches for f in counters]
    eager = render(scene, cam, config)
    got = [render_jit(scene, cam, config) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(f.launches > b for f, b in zip(counters, before))
    assert (eager.hit_obj == 1).any() and (eager.hit_obj == 0).any()
    for out in got:
        for f in ("image", "radiance", "hit_t", "hit_tri", "hit_obj",
                  "normal", "point"):
            assert torch.equal(getattr(out, f), getattr(eager, f)), f
