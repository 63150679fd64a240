"""The bin path's traversal (the JAX package's ``accel/traverse.py``
``_ray_table``, ``_untile`` and ``intersect_binned``): per-tile ray table,
screen-space binning, the bin-intersect kernel, and back to image order.
"""

from __future__ import annotations

import torch

from ..ops.cuda.bin_intersect import bin_intersect
from ..ops.intersect import Hit
from .binning import BinnedScene, bin_triangles


def _ray_table(proj, o, bmin, bmax, n_tiles: int, n_tx: int,
               th: int, tw: int, draw_distance: float) -> torch.Tensor:
    """(n_tiles, th*tw, 4) f32 [dx | dy | dz | scene-exit bound] in
    row-major tile order. The bound is the far slab intersection with the
    object's root AABB (+1e-3), 0 when the ray misses the box; it is the
    comparand of the kernel's depth gate."""
    p = th * tw
    n = n_tiles * p
    idx = torch.arange(n, device=o.device)
    t = idx // p
    pi = idx - t * p
    ix = ((t % n_tx) * tw + pi % tw).to(torch.float32)
    iy = ((t // n_tx) * th + pi // tw).to(torch.float32)

    um = proj.u / proj.sx
    vm = proj.v / proj.sy
    base = proj.n - um * proj.adjust_x - vm * proj.adjust_y
    dc = [base[ax] + um[ax] * ix + vm[ax] * iy for ax in range(3)]
    inv_len = torch.rsqrt(dc[0] * dc[0] + dc[1] * dc[1] + dc[2] * dc[2])
    d = [c * inv_len for c in dc]

    r_near = torch.full((n,), -torch.inf, dtype=torch.float32, device=o.device)
    r_far = torch.full((n,), torch.inf, dtype=torch.float32, device=o.device)
    for ax in range(3):
        dax = d[ax]
        dsf = torch.where(dax.abs() < 1e-30,
                          torch.where(dax < 0, -1e-30, 1e-30), dax)
        inv = torch.reciprocal(dsf)
        ta = (bmin[ax] - o[ax]) * inv
        tb = (bmax[ax] - o[ax]) * inv
        r_near = torch.maximum(r_near, torch.minimum(ta, tb))
        r_far = torch.minimum(r_far, torch.maximum(ta, tb))
    root_hit = r_far >= torch.clamp_min(r_near, 0.0) - 1e-4
    bnd = torch.clamp_max(torch.where(root_hit, r_far + 1e-3, 0.0),
                          float(draw_distance))
    return torch.stack([*d, bnd], dim=-1).reshape(n_tiles, p, 4)


def _untile(x: torch.Tensor, h2: int, w2: int, th: int, tw: int,
            res_h: int, res_w: int) -> torch.Tensor:
    """(nT, P) per-tile values -> (res_h, res_w) image order."""
    full = (x.reshape(h2 // th, w2 // tw, th, tw).permute(0, 2, 1, 3)
            .reshape(h2, w2))
    return full[:res_h, :res_w]


def bin_object(o: torch.Tensor, tris, proj, config, res_h: int, res_w: int
               ) -> tuple[torch.Tensor, BinnedScene]:
    """The kernel's operands for one object: the per-tile ray table and
    the binned entry table, at the image padded to whole tiles."""
    th, tw = config.tile_h, config.tile_w
    h2, w2 = -(-res_h // th) * th, -(-res_w // tw) * tw
    n_tx = w2 // tw
    n_tiles = (h2 // th) * n_tx
    bmin, bmax = [], []
    for v1, d1, d2 in ((tris.p1x, tris.e1x, tris.e2x),
                       (tris.p1y, tris.e1y, tris.e2y),
                       (tris.p1z, tris.e1z, tris.e2z)):
        v2, v3 = v1 + d1, v1 + d2
        bmin.append(torch.minimum(torch.minimum(v1, v2), v3).amin())
        bmax.append(torch.maximum(torch.maximum(v1, v2), v3).amax())
    rays = _ray_table(proj, o, bmin, bmax, n_tiles, n_tx, th, tw,
                      config.draw_distance)
    binned = bin_triangles(proj, o,
                           (tris.p1x, tris.p1y, tris.p1z),
                           (tris.e1x, tris.e1y, tris.e1z),
                           (tris.e2x, tris.e2y, tris.e2z),
                           h2, w2, th, tw, chunk=config.bin_chunk,
                           eps=config.eps,
                           backface_cull=config.backface_cull)
    return rays, binned


def intersect_binned(o: torch.Tensor, d: torch.Tensor, tris, proj, config,
                     res_h: int, res_w: int):
    """Nearest hit per primary ray by screen-space binning + the
    bin-intersect kernel.

    ``proj`` is the camera Projection in the object's frame and ``o`` the
    object-frame origin. Primary rays only: directions are regenerated per
    tile from ``proj``, so ``d`` is ignored (it keeps the call shape of the
    other methods). The entry table is sized from the live count, so the
    JAX package's ``bin_e_factor`` / ``bin_escalate`` have nothing to do.

    With ``config.with_stats`` the kernel runs its telemetry switch (K3,
    with ``config.bin_esub`` slices) and the result is (Hit, stats):
    ``steps`` (nT,) slices scanned and ``chunks`` (nT,) blocks walked per
    tile, ``entries`` (int), ``overflow`` (always 0: nothing is dropped)
    and ``cross`` (camera-plane-crossing triangles).
    """
    del d
    th, tw = config.tile_h, config.tile_w
    if config.sub_h or config.sub_w:
        raise ValueError("method='bin' generates rays in row-major tile "
                         "order; sub_h/sub_w are a cluster-path option")
    rays, binned = bin_object(o, tris, proj, config, res_h, res_w)
    out = bin_intersect(rays, binned.geom, binned.entry_tri, binned.starts,
                        config.bin_chunk, config.eps, config.draw_distance,
                        esub=config.bin_esub if config.with_stats else 1,
                        with_steps=config.with_stats)
    h2, w2 = -(-res_h // th) * th, -(-res_w // tw) * tw
    t = _untile(out[0], h2, w2, th, tw, res_h, res_w).reshape(-1)
    tri = _untile(out[1], h2, w2, th, tw, res_h, res_w).reshape(-1)
    hit = Hit(t=t, tri=tri, obj=torch.where(tri >= 0, 0, -1).to(torch.int32))
    if config.with_stats:
        return hit, {"steps": out[2][:, 0], "chunks": out[2][:, 1],
                     "overflow": 0, "entries": binned.num_entries,
                     "cross": binned.cross_tris}
    return hit
