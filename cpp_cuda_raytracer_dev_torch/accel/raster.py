"""Scatter-min z-buffer rasterization, ``method="raster"`` (the JAX
package's ``accel/raster.py``): primary-ray intersection without a sort or
per-tile segments, in plain PyTorch (the JAX package writes it in plain XLA
too, outside any Pallas kernel).

A pixel's primary ray can hit only triangles whose projection covers the
pixel centre, so per triangle the pixels of its projected bbox (up to
``raster_span`` a side) are enumerated and z-combined with two exact
scatter-minima. Acceptance is the oracle's: every primary direction is
affine in pixel coordinates,

    D(ix, iy) = n + (ix - ax)/sx * u + (iy - ay)/sy * v,

so every Möller–Trumbore contraction D·m with the fixed-origin constants
(`FixedOriginCache`, the reference's camera-space cache, Trixel.cu:29-36)
is affine in (ix, iy) too. u = ud/det and v = vd/det do not depend on |D|,
and t_aff = td/det scales by the same 1/|D| for every triangle of a pixel,
so the per-pixel order is the true one; the distance is t_aff * |D| with
|D|² = 1 + ((ix-ax)/sx)² + ((iy-ay)/sy)² (n, u, v orthonormal).

Winner selection is two exact scatter-minima:
  1. zmin[pix] = min over covering pairs of the float32 bits of t_aff read
     as int32 (positive floats order like their bits);
  2. tri[pix] = min triangle id among the pairs whose bits equal zmin (an
     exact tie goes to the lowest id, as in the oracle).

Triangles whose bbox exceeds the span, or that cross the camera plane, go
to a dense MT pass against every ray. The JAX package holds that list at a
static capacity (``raster_ovf_cap``, escalated once to 4x) and counts what
is left over; the port takes every such triangle, sized from the live
count (one host sync), so nothing is dropped and the residual is always 0
(as the bin table, ROADMAP F3). The stats keep the JAX keys.
"""

from __future__ import annotations

import torch

from ..ops.intersect import FixedOriginCache, Hit, mt_fixed_origin
from ..utils.config import RenderConfig

_MAXI = torch.iinfo(torch.int32).max


def intersect_raster(o: torch.Tensor, d: torch.Tensor, tris, proj,
                     config: RenderConfig, res_h: int, res_w: int):
    """Nearest hit per pixel by scatter-min rasterization.

    o: (3,) object-frame origin (equal to ``proj.origin``); d: (R, 3) unit
    object-frame directions, row-major (R = res_h * res_w); proj: the
    Projection in the object frame (of a band of rows when ``row0`` > 0).
    Returns a Hit, and with ``config.with_stats`` also the stats:
    ``overflow`` (always 0), ``ovf_tris`` (triangles in the dense pass) and
    ``pairs`` (accepted (triangle, pixel) pairs of the scatter pass).
    """
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    dev = d.device
    proj = proj.band_local()         # pixel rows of the band (row0 > 0)
    t_n = tris.p1x.shape[0]
    npix = res_h * res_w
    span = config.raster_span
    guard = 0.5

    p1, e1, e2 = tris.p1, tris.e1, tris.e2
    cache = FixedOriginCache.build(proj.origin, tris)

    # ---- projection of the 3 vertices ----
    basis = torch.stack([proj.n, proj.u, proj.v], dim=1)     # (3, 3)
    abc0 = (p1 - proj.origin[None, :]) @ basis               # (T, 3)
    dabc1 = e1 @ basis
    dabc2 = e2 @ basis
    a = torch.stack([abc0[:, 0], abc0[:, 0] + dabc1[:, 0],
                     abc0[:, 0] + dabc2[:, 0]], dim=1)       # (T, 3)
    b = torch.stack([abc0[:, 1], abc0[:, 1] + dabc1[:, 1],
                     abc0[:, 1] + dabc2[:, 1]], dim=1)
    c = torch.stack([abc0[:, 2], abc0[:, 2] + dabc1[:, 2],
                     abc0[:, 2] + dabc2[:, 2]], dim=1)

    all_front = (a > 0.0).all(dim=1)
    a_safe = torch.clamp_min(a, 1e-20)
    px = proj.adjust_x + proj.sx * (b / a_safe)              # (T, 3)
    py = proj.adjust_y + proj.sy * (c / a_safe)
    x0 = px.amin(dim=1) - guard
    x1 = px.amax(dim=1) + guard
    y0 = py.amin(dim=1) - guard
    y1 = py.amax(dim=1) + guard
    # clamp in float before the int casts (out-of-range casts are undefined)
    ix0 = torch.clamp(torch.ceil(x0), 0, res_w - 1).to(i64)
    ix1 = torch.floor(torch.clamp(x1, 0, res_w - 1)).to(i64)
    iy0 = torch.clamp(torch.ceil(y0), 0, res_h - 1).to(i64)
    iy1 = torch.floor(torch.clamp(y1, 0, res_h - 1)).to(i64)
    onscreen = (all_front & (x1 >= 0) & (x0 <= res_w - 1)
                & (y1 >= 0) & (y0 <= res_h - 1)
                & (ix1 >= ix0) & (iy1 >= iy0))
    nx = ix1 - ix0 + 1
    ny = iy1 - iy0 + 1
    fits = (nx <= span) & (ny <= span)
    live = onscreen & fits

    # ---- affine MT coefficients per triangle ----
    isx = torch.reciprocal(proj.sx)
    isy = torch.reciprocal(proj.sy)
    nuv = torch.stack([proj.n, proj.u * isx, proj.v * isy], dim=0)  # (3, 3)
    cd = cache.m_det @ nuv.T                                 # (T, 3) A,Bu,Bv
    cu = cache.m_u @ nuv.T
    cv = cache.m_v @ nuv.T
    td = cache.tdet                                          # (T,)
    fx0 = ix0.to(f32) - proj.adjust_x
    fy0 = iy0.to(f32) - proj.adjust_y
    det0 = cd[:, 0] + fx0 * cd[:, 1] + fy0 * cd[:, 2]
    ud0 = cu[:, 0] + fx0 * cu[:, 1] + fy0 * cu[:, 2]
    vd0 = cv[:, 0] + fx0 * cv[:, 1] + fy0 * cv[:, 2]

    eps = config.eps
    pix_base = iy0 * res_w + ix0

    # ---- MT at the span x span candidate grid, one (pixel, bits) pair
    # per (offset, triangle); rejected pairs point at the dump pixel npix
    pix_all, bits_all = [], []
    for dy in range(span):
        for dx in range(span):
            det = det0 + dx * cd[:, 1] + dy * cd[:, 2]       # (T,)
            ud = ud0 + dx * cu[:, 1] + dy * cu[:, 2]
            vd = vd0 + dx * cv[:, 1] + dy * cv[:, 2]
            inv = torch.reciprocal(det)
            u = ud * inv
            v = vd * inv
            t = td * inv
            ok = (live & (dx < nx) & (dy < ny)
                  & (det.abs() >= eps) & (u >= eps) & (v >= eps)
                  & (u + v <= 1.0 + eps) & (t >= eps))
            pix_all.append(torch.where(ok, pix_base + dy * res_w + dx, npix))
            bits_all.append(torch.where(ok, t.view(i32), _MAXI))
    pix = torch.cat(pix_all)                                 # (span² T,)
    bits = torch.cat(bits_all)

    # ---- two-pass exact scatter-min z-buffer ----
    zmin = torch.full((npix + 1,), _MAXI, dtype=i32, device=dev)
    zmin.scatter_reduce_(0, pix, bits, "amin")
    eq = bits == zmin[pix]
    tri_id = torch.arange(t_n, dtype=i32, device=dev).repeat(span * span)
    win = torch.full((npix + 1,), _MAXI, dtype=i32, device=dev)
    win.scatter_reduce_(0, torch.where(eq, pix, npix), tri_id, "amin")

    zmin = zmin[:npix]
    win = win[:npix]
    t_aff = zmin.view(f32)
    # |D| per pixel: n, u, v orthonormal => |D|² = 1 + fx² + fy²
    ixg = torch.arange(res_w, dtype=f32, device=dev) - proj.adjust_x
    iyg = torch.arange(res_h, dtype=f32, device=dev) - proj.adjust_y
    d2 = (1.0 + (ixg[None, :] * isx) ** 2
          + (iyg[:, None] * isy) ** 2).reshape(-1)
    t_true = t_aff * torch.sqrt(d2)
    hit_ok = (zmin != _MAXI) & (t_true < config.draw_distance)
    draw = torch.full_like(t_true, config.draw_distance)
    hit = Hit(t=torch.where(hit_ok, t_true, draw),
              tri=torch.where(hit_ok, win, -1),
              obj=torch.where(hit_ok, 0, -1).to(i32))

    # ---- dense pass: wider than the span, or crossing the camera plane,
    # every such triangle (the live count sizes the list) in ascending id
    # order, so the oracle's chunk scan gives the lowest id on a tie
    ovf_mask = (onscreen & ~fits) | ((a <= 0.0).any(dim=1)
                                     & (a > 0.0).any(dim=1))
    sel = torch.nonzero(ovf_mask).squeeze(1)                 # one host sync
    n_ovf = sel.shape[0]
    if n_ovf:
        sub = FixedOriginCache(m_det=cache.m_det[sel], m_u=cache.m_u[sel],
                               m_v=cache.m_v[sel], tdet=td[sel])
        o_hit = mt_fixed_origin(d, sub, config.draw_distance, eps,
                                config.chunk)
        found = o_hit.tri >= 0
        o_hit.tri = torch.where(found, sel.to(i32)[o_hit.tri.clamp_min(0)],
                                -1)
        o_hit.obj = torch.where(found, 0, -1).to(i32)
        hit = hit.merge(o_hit)

    if config.with_stats:
        return hit, {"overflow": 0, "ovf_tris": n_ovf,
                     "pairs": int((pix < npix).sum())}
    return hit
