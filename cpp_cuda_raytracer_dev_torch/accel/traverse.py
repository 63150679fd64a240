"""Ray traversal (the JAX package's ``accel/traverse.py``): the cluster
paths and the bin path.

Cluster paths (``method`` "grid", "pallas", "pallas2"): `ClusterAccel`
stops the KD build (accel/kd_build.py) at wide leaves, "clusters" of up to
``leaf_size`` triangles in padded slots. Per ray tile (a rectangle of
coherent primary rays) every cluster AABB is tested against the tile's
4-plane frustum (`cull_tiles`, or `cull_tiles_hier` through groups of
clusters first), the nearest ``max_candidates`` visible clusters are kept,
and the tile's rays are intersected with them: by dense plain PyTorch
(`intersect_clustered`, "grid"), by kernel K5 (`intersect_clustered_pallas`,
"pallas") or by kernel K4 with its early exit and an exact second pass
over the tiles whose candidate list overflowed
(`intersect_clustered_pallas_v2`, "pallas2"). Candidate order is a stable
sort, as ``jax.lax.top_k``'s is, so equal keys keep the lower cluster
first. On CUDA tensors kernel K14 (``ops/cuda/tile_intersect.py``
`cluster_cull`) runs a whole cull pass, the candidates' boxes included, in
one launch; on CPU tensors its plain twins here (`cull_tiles_reference`,
`cull_tiles_hier_reference`, `_candidate_boxes`), vectorised over tiles as
the JAX package's ``vmap`` is, give the same bits.

Bin path (``method="bin"``): per-tile ray table, screen-space binning, the
bin-intersect kernel K1, and back to image order.

KD path (``method="kd"``): `KDTables`, the flattened KD tree, and
`kd_intersect`, the reference's per-ray stack traversal: kernel K7 on the
card (one thread a ray), its plain version `kd_intersect_plain` (in
lockstep over all rays) on the CPU.
"""

from __future__ import annotations

import dataclasses
import numpy as np
import torch

from ..ops import vecmath
from ..ops.cuda.bin_intersect import bin_intersect
from ..ops.cuda.bin_prepass import ray_table
from ..ops.cuda.kd_traverse import kd_traverse, kd_traverse_reference
from ..ops.cuda.tile_intersect import (cluster_cull, tile_intersect,
                                       tile_intersect_v2)
from ..ops.intersect import Hit, mt_test
from .binning import BinnedScene, bin_triangles
from ..utils.dtypes import DEFAULT_DRAW_DISTANCE, MT_EPSILON, SLAB_EPSILON
from ..utils.graphs import Budget
from ..utils.profiling import tally
from .kd_build import KDTree

_CULL_ELEMS = 1 << 25     # (tile, plane, cluster) distances per cull group
_GRID_PAIRS = 1 << 25     # (ray, slot) pairs per tile group of the grid path
_FAR = 3.0e38


@dataclasses.dataclass
class ClusterAccel:
    """Wide-leaf KD clusters with padded triangle slots, on the triangles'
    device.

    One geometry layout serves both kernels and the grid path: ``geom9``
    (C, 9, Lpad) with rows p1.xyz | e1.xyz | e2.xyz and the slots on the
    last axis, padded with zeros to a multiple of 128 (the JAX package's
    ``geom9_t``); `geom_t` is its (C, L, 9) view (the JAX ``geom_t``).
    Padding slots have ``slot_mat`` -1 and zero geometry (det = 0, never
    hit).
    """

    bounds_min: torch.Tensor   # (C, 3) float32
    bounds_max: torch.Tensor   # (C, 3)
    centers: torch.Tensor      # (C, 3)
    geom9: torch.Tensor        # (C, 9, Lpad) float32
    slot_mat: torch.Tensor     # (C, L) int32 triangle id, -1 = padding
    leaf_size: int

    @property
    def num_clusters(self) -> int:
        return self.bounds_min.shape[0]

    @property
    def geom_t(self) -> torch.Tensor:
        """(C, L, 9) view of the slot geometry."""
        return self.geom9[:, :, :self.slot_mat.shape[1]].transpose(1, 2)

    @property
    def slot_tri(self) -> torch.Tensor:
        return self.slot_mat.reshape(-1)

    @classmethod
    def build(cls, tris, leaf_size: int = 128,
              cache: bool = True) -> "ClusterAccel":
        """Host-side build: KD build (the native builder where g++ is
        there, accel/native.py) -> leaf extraction -> padding (numpy), then
        one copy to the triangles' device. With ``cache`` the KD tree is
        loaded from or saved to the disk cache (utils/cache.py)."""
        p1, e1, e2 = (x.detach().cpu().numpy() for x in
                      (tris.p1, tris.e1, tris.e2))
        v = np.stack([p1, p1 + e1, p1 + e2], axis=1)
        amin, amax = v.min(axis=1), v.max(axis=1)
        if cache:
            from ..utils.cache import build_kd_cached
            tree = build_kd_cached(amin, amax, min_node_size=leaf_size)
        else:
            from .native import build_kd_fast
            tree = build_kd_fast(amin, amax, min_node_size=leaf_size)
        leaf_ids = np.nonzero(tree.is_leaf)[0]
        c = leaf_ids.shape[0]
        ln = leaf_size
        starts = tree.leaf_start[leaf_ids].astype(np.int64)    # (C,)
        counts = tree.leaf_count[leaf_ids].astype(np.int64)
        lane = np.arange(ln, dtype=np.int64)[None, :]          # (1, L)
        valid = lane < counts[:, None]                         # (C, L)
        pos = np.minimum(starts[:, None] + lane, p1.shape[0] - 1)
        ids = tree.perm[pos]                                   # (C, L)
        slot_tri = np.where(valid, ids, -1).astype(np.int32)
        v3 = valid[:, :, None]
        sp1 = np.where(v3, p1[ids], 0.0).astype(np.float32)
        se1 = np.where(v3, e1[ids], 0.0).astype(np.float32)
        se2 = np.where(v3, e2[ids], 0.0).astype(np.float32)
        bmin = tree.bounds_min[leaf_ids]
        bmax = tree.bounds_max[leaf_ids]
        geom_t = np.concatenate([sp1, se1, se2], axis=2)  # (C, L, 9)
        lpad = (-ln) % 128
        geom9 = np.transpose(geom_t, (0, 2, 1))           # (C, 9, L)
        if lpad:
            geom9 = np.concatenate(
                [geom9, np.zeros((c, 9, lpad), np.float32)], axis=2)
        dev = tris.p1x.device

        def t(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        return cls(bounds_min=t(bmin), bounds_max=t(bmax),
                   centers=t((bmin + bmax) / 2.0), geom9=t(geom9),
                   slot_mat=t(slot_tri), leaf_size=leaf_size)


def _tile_rays(d: torch.Tensor, res_h: int, res_w: int, th: int, tw: int,
               sh: int = 0, sw: int = 0):
    """(R, 3) row-major rays -> (nT, P, 3) tiles + untile metadata, the
    image padded to whole tiles by repeating its edge.

    With sh/sw set, rays within a tile are ordered sub-tile-major: each
    (sh, sw) sub-tile occupies a contiguous run of the P axis."""
    hp = (-res_h) % th
    wp = (-res_w) % tw
    img = d.reshape(res_h, res_w, 3)
    if hp or wp:
        rows = torch.arange(res_h + hp, device=d.device).clamp_max(res_h - 1)
        cols = torch.arange(res_w + wp, device=d.device).clamp_max(res_w - 1)
        img = img[rows][:, cols]
    h2, w2 = res_h + hp, res_w + wp
    if sh and sw and (sh, sw) != (th, tw):
        tiles = (img.reshape(h2 // th, th // sh, sh, w2 // tw, tw // sw, sw,
                             3)
                 .permute(0, 3, 1, 4, 2, 5, 6)
                 .reshape(-1, th * tw, 3))
    else:
        sh, sw = 0, 0
        tiles = (img.reshape(h2 // th, th, w2 // tw, tw, 3)
                 .permute(0, 2, 1, 3, 4)
                 .reshape(-1, th * tw, 3))
    return tiles, (h2, w2, th, tw, hp, wp, sh, sw)


def _untile(x: torch.Tensor, meta, res_h: int, res_w: int) -> torch.Tensor:
    """(nT, P, ...) per-tile values -> (res_h, res_w, ...) image order."""
    h2, w2, th, tw, _, _, sh, sw = meta
    tail = tuple(x.shape[2:])
    if sh and sw:
        full = (x.reshape(h2 // th, w2 // tw, th // sh, tw // sw, sh, sw,
                          *tail)
                .permute(0, 2, 4, 1, 3, 5, *range(6, x.dim() + 4)))
    else:
        full = (x.reshape(h2 // th, w2 // tw, th, tw, *tail)
                .permute(0, 2, 1, 3, *range(4, x.dim() + 2)))
    return full.reshape(h2, w2, *tail)[:res_h, :res_w]


def _corner_idx(th: int, tw: int, sh: int = 0, sw: int = 0):
    """P-axis positions of the tile's 4 corner rays (00, 01, 10, 11) under
    row-major or sub-tile-major ray ordering (see _tile_rays)."""
    if not (sh and sw):
        return 0, tw - 1, (th - 1) * tw, th * tw - 1
    sub = sh * sw
    c01 = (tw // sw - 1) * sub + (sw - 1)
    c10 = (th // sh - 1) * (tw // sw) * sub + (sh - 1) * sw
    return 0, c01, c10, th * tw - 1


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot products over the last axis summed in one order on every device,
    (a0 b0 + a1 b1) + a2 b2 (the CPU's sum; the card's reduction picks its
    own), so that K14 repeats them bit for bit."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) \
        + a[..., 2] * b[..., 2]


def _tile_frustum_visible(o: torch.Tensor, tiles: torch.Tensor,
                          center: torch.Tensor, bmin: torch.Tensor,
                          bmax: torch.Tensor, th: int, tw: int, sh: int = 0,
                          sw: int = 0):
    """Visibility of cluster AABBs from each tile's ray cone.

    tiles: (n, P, 3), center (n, 3) their mean over P; bmin/bmax: (C, 3)
    shared by all tiles or (n, C, 3) per tile. Directions are affine in
    pixel coordinates, so the 4 corner rays bound the cone; each side plane
    passes through the origin, and a box is outside when its corner
    furthest along the plane's inward normal is behind it. Returns (visible
    (n, C), tnear (n, C)), tnear the box centre's distance along the tile's
    mean direction.
    """
    i00, i01, i10, i11 = _corner_idx(th, tw, sh, sw)
    c00, c01, c10, c11 = (tiles[:, i] for i in (i00, i01, i10, i11))
    corners = torch.stack([c00, c01, c11, c10], dim=1)      # (n, 4, 3)
    nxt = torch.stack([c01, c11, c10, c00], dim=1)
    normals = vecmath.cross(corners, nxt)
    flip = torch.sign(_dot3(normals, center[:, None, :]))[..., None]
    normals = normals * torch.where(flip == 0, 1.0, flip)
    if bmin.dim() == 2:
        bmin, bmax = bmin[None], bmax[None]                 # (1|n, C, 3)
    # the p-vertex distance per plane, summed over x, y, z in turn, so no
    # (n, 4, C, 3) temporary is made
    dist = None
    for a in range(3):
        n_a = normals[:, :, a, None]                        # (n, 4, 1)
        lo = (bmin[..., a] - o[a])[:, None, :]              # (1|n, 1, C)
        hi = (bmax[..., a] - o[a])[:, None, :]
        term = n_a * torch.where(n_a > 0, hi, lo)
        dist = term if dist is None else dist + term
    visible = (dist >= 0.0).all(dim=1)
    tnear = _dot3((bmin + bmax) / 2.0 - o, center[:, None, :])
    return visible, tnear


def _nearest_k(key: torch.Tensor, k: int) -> torch.Tensor:
    """Column indices of the k smallest keys per row, ascending; equal keys
    keep the lower index first (``jax.lax.top_k(-key, k)``'s order)."""
    return torch.sort(key, dim=1, stable=True).indices[:, :k]


def _cull_group(per_tile: int) -> int:
    """Tiles per cull group, for ``per_tile`` plane distances a tile."""
    return max(1, _CULL_ELEMS // max(per_tile, 1))


def cull_tiles(o: torch.Tensor, tiles: torch.Tensor, accel: ClusterAccel,
               th: int, tw: int, k: int, sh: int = 0, sw: int = 0,
               boxes: bool = False):
    """Frustum-cull every cluster against every tile's ray cone.

    tiles: (nT, P, 3). Returns (cand (nT, K) int32 nearest-first, count
    (nT,) int32 visible clusters clamped to K, overflow (nT,) int32 visible
    clusters past K), and with ``boxes`` the candidates' boxes
    (`_candidate_boxes`) fourth. Kernel K14 on CUDA tensors, one launch;
    `cull_tiles_reference` on CPU tensors; the two agree bit for bit.
    """
    return _cull_pass(o, tiles, accel, th, tw, k, sh, sw, 0, 0, boxes)


def cull_tiles_hier(o: torch.Tensor, tiles: torch.Tensor, accel: ClusterAccel,
                    th: int, tw: int, k: int, group: int, kg: int,
                    sh: int = 0, sw: int = 0, boxes: bool = False):
    """Two-level frustum cull: groups of `group` consecutive clusters (KD
    leaf order, so spatially coherent) are tested first; only the nearest
    `kg` visible groups have their member clusters tested. Same contract as
    `cull_tiles`; the clusters of visible groups past the `kg` budget count
    as overflow (an upper bound), so escalation picks those tiles up.
    Kernel K14 on CUDA tensors, `cull_tiles_hier_reference` on CPU tensors.
    """
    return _cull_pass(o, tiles, accel, th, tw, k, sh, sw, group, kg, boxes)


def _cull_pass(o, tiles, accel: ClusterAccel, th, tw, k, sh, sw, group, kg,
               boxes):
    """One cull pass, flat (``group`` 0) or through groups: K14 or the
    twins, by the tiles' device."""
    if tiles.device.type == "cuda":
        tiles = tiles.contiguous()
        kg = min(kg, -(-accel.num_clusters // group)) if group else 0
        out = cluster_cull(o.contiguous(), tiles, tiles.mean(dim=1),
                           accel.bounds_min, accel.bounds_max,
                           _corner_idx(th, tw, sh, sw), k, group, kg, boxes)
        return out if boxes else out[:3]
    out = (cull_tiles_hier_reference(o, tiles, accel, th, tw, k, group, kg,
                                     sh, sw) if group else
           cull_tiles_reference(o, tiles, accel, th, tw, k, sh, sw))
    if boxes:
        return (*out, _candidate_boxes(o, accel, out[0], out[1]))
    return out


def cull_tiles_reference(o: torch.Tensor, tiles: torch.Tensor,
                         accel: ClusterAccel, th: int, tw: int, k: int,
                         sh: int = 0, sw: int = 0):
    """`cull_tiles` (without boxes) in plain PyTorch on any device: K14's
    twin, in tile groups that bound the (tile, plane, cluster)
    temporaries."""
    out = []
    center = tiles.mean(dim=1)                              # (nT, 3)
    step = _cull_group(4 * accel.num_clusters)
    for i in range(0, tiles.shape[0], step):
        visible, tnear = _tile_frustum_visible(
            o, tiles[i:i + step], center[i:i + step], accel.bounds_min,
            accel.bounds_max, th, tw, sh, sw)
        cand = _nearest_k(torch.where(visible, tnear, torch.inf), k)
        nvis = visible.sum(dim=1, dtype=torch.int32)
        out.append((cand.to(torch.int32), torch.clamp_max(nvis, k),
                    torch.clamp_min(nvis - k, 0)))
    return tuple(torch.cat(x) for x in zip(*out))


def cull_tiles_hier_reference(o: torch.Tensor, tiles: torch.Tensor,
                              accel: ClusterAccel, th: int, tw: int, k: int,
                              group: int, kg: int, sh: int = 0, sw: int = 0):
    """`cull_tiles_hier` (without boxes) in plain PyTorch on any device:
    K14's twin."""
    c = accel.num_clusters
    dev = accel.bounds_min.device
    pad = (-c) % group
    gmin, gmax = accel.bounds_min, accel.bounds_max
    if pad:
        gmin = torch.cat([gmin, torch.full((pad, 3), _FAR, device=dev)])
        gmax = torch.cat([gmax, torch.full((pad, 3), -_FAR, device=dev)])
    ng = gmin.shape[0] // group
    gb_min = gmin.reshape(ng, group, 3).amin(dim=1)        # (G, 3)
    gb_max = gmax.reshape(ng, group, 3).amax(dim=1)
    kg = min(kg, ng)
    if k > kg * group:
        raise ValueError(f"max_candidates {k} exceeds max_groups x "
                         f"group_size = {kg * group}")
    lane = torch.arange(group, device=dev)
    out = []
    center = tiles.mean(dim=1)                              # (nT, 3)
    step = _cull_group(4 * max(ng, kg * group))
    for i in range(0, tiles.shape[0], step):
        tg, cg = tiles[i:i + step], center[i:i + step]
        gvis, gnear = _tile_frustum_visible(o, tg, cg, gb_min, gb_max, th,
                                            tw, sh, sw)
        gsel = _nearest_k(torch.where(gvis, gnear, torch.inf), kg)
        gsel_valid = gvis.gather(1, gsel)
        cl_raw = (gsel[:, :, None] * group + lane).reshape(tg.shape[0], -1)
        cl = cl_raw.clamp_max(c - 1)                       # clamp pad tail
        visible, tnear = _tile_frustum_visible(
            o, tg, cg, accel.bounds_min[cl], accel.bounds_max[cl], th, tw,
            sh, sw)
        visible = (visible & (cl_raw < c)
                   & gsel_valid.repeat_interleave(group, dim=1))
        sel = _nearest_k(torch.where(visible, tnear, torch.inf), k)
        cand = cl.gather(1, sel)
        nvis = visible.sum(dim=1, dtype=torch.int32)
        ngvis = gvis.sum(dim=1, dtype=torch.int32)
        out.append((cand.to(torch.int32), torch.clamp_max(nvis, k),
                    torch.clamp_min(nvis - k, 0)
                    + torch.clamp_min(ngvis - kg, 0) * group))
    return tuple(torch.cat(x) for x in zip(*out))


def _cull(o, tiles, accel, config, k, sh=0, sw=0, boxes=False):
    """The cull the configuration asks for: two levels where
    ``max_groups`` > 0, else flat (`cull_tiles_hier`, `cull_tiles`)."""
    if config.max_groups > 0:
        return cull_tiles_hier(o, tiles, accel, config.tile_h, config.tile_w,
                               k, config.group_size, config.max_groups, sh,
                               sw, boxes)
    return cull_tiles(o, tiles, accel, config.tile_h, config.tile_w, k, sh,
                      sw, boxes)


def _candidate_boxes(o: torch.Tensor, accel: ClusterAccel, cand: torch.Tensor,
                     count: torch.Tensor) -> torch.Tensor:
    """(nT, K) candidates -> (nT, K, 8) AABBs (bmin | bmax) with the
    suffix-min conservative origin-to-AABB distance in column 6.

    For unit directions the distance bounds any hit t inside the cluster
    from below; its suffix minimum over the nearest-first order is K4's
    loop-exit certificate. Candidates past ``count`` get 3e38. Plain
    PyTorch on any device: the twin of K14's boxes, which a cull with
    ``boxes`` writes in its own launch on CUDA tensors."""
    gap = torch.clamp_min(torch.maximum(accel.bounds_min - o,
                                        o - accel.bounds_max), 0.0)
    dist_c = torch.sqrt(_dot3(gap, gap))                    # (C,)
    box8 = torch.cat([accel.bounds_min, accel.bounds_max, dist_c[:, None],
                      torch.zeros_like(dist_c)[:, None]], dim=1)  # (C, 8)
    boxes = box8[cand.long()]                               # (nT, K, 8)
    kk = torch.arange(cand.shape[1], device=cand.device)
    dist = torch.where(kk < count[:, None], boxes[:, :, 6], _FAR)
    boxes[:, :, 6] = torch.flip(torch.cummin(torch.flip(dist, [1]), dim=1)
                                .values, [1])
    return boxes


def _hit(t_tiles, tri_tiles, meta, res_h, res_w) -> Hit:
    t = _untile(t_tiles, meta, res_h, res_w).reshape(-1)
    tri = _untile(tri_tiles, meta, res_h, res_w).reshape(-1)
    return Hit(t=t, tri=tri, obj=torch.where(tri >= 0, 0, -1).to(torch.int32))


def intersect_clustered(o: torch.Tensor, d: torch.Tensor, tris,
                        accel: ClusterAccel, config, res_h: int,
                        res_w: int) -> Hit:
    """Nearest hit via the flat tile frustum cull and a dense MT over each
    tile's K candidates x L slots, in plain PyTorch ("grid").

    o: (3,) object-frame origin; d: (R, 3) object-frame unit directions in
    row-major image order (R = res_h * res_w). ``tris`` is unused (it keeps
    the JAX signature). Tiles run in groups that bound the (ray, slot)
    temporaries, as the JAX package's ``lax.map(batch_size=8)`` does; the
    dot products are elementwise sums, so no TF32 can enter.
    """
    del tris
    th, tw = config.tile_h, config.tile_w
    k = min(config.max_candidates, accel.num_clusters)
    ln = accel.slot_mat.shape[1]
    eps, draw = config.eps, config.draw_distance

    # per-frame, per-object fixed-origin MT constants for every slot
    g = accel.geom_t.reshape(-1, 9)
    p1, e1, e2 = g[:, 0:3], g[:, 3:6], g[:, 6:9]
    tvec = o[None, :] - p1
    m_det = vecmath.cross(e2, e1)                           # (S, 3)
    m_u = vecmath.cross(e2, tvec)
    m_v = vecmath.cross(tvec, e1)
    tdet = vecmath.dot(e2, m_v)                             # (S,)
    slot_tri = accel.slot_tri

    tiles, meta = _tile_rays(d, res_h, res_w, th, tw)
    cand, count, _ = cull_tiles(o, tiles, accel, th, tw, k)
    p = tiles.shape[1]
    lane = torch.arange(ln, device=d.device)
    # the cull sorts visible clusters first, so candidate j is valid iff
    # j < count
    cand_valid = torch.arange(k, device=d.device) < count[:, None]
    t_out, tri_out = [], []
    step = max(1, _GRID_PAIRS // (p * k * ln))
    for i in range(0, tiles.shape[0], step):
        tg = tiles[i:i + step]
        n = tg.shape[0]
        slot = (cand[i:i + step, :, None].long() * ln + lane).reshape(n, -1)
        sl_tri = torch.where(cand_valid[i:i + step].repeat_interleave(ln, 1),
                             slot_tri[slot], -1)            # (n, K*L)
        md, mu, mv = m_det[slot], m_u[slot], m_v[slot]      # (n, K*L, 3)
        td = tdet[slot]
        dx, dy, dz = (tg[:, :, a, None] for a in range(3))  # (n, P, 1)

        def dot3(m):
            return (dx * m[:, None, :, 0] + dy * m[:, None, :, 1]
                    + dz * m[:, None, :, 2])                # (n, P, K*L)
        det = dot3(md)
        inv = torch.reciprocal(det)
        u = dot3(mu) * inv
        v = dot3(mv) * inv
        t = td[:, None, :] * inv
        ok = ((det.abs() >= eps) & (u >= eps) & (v >= eps)
              & (u + v <= 1.0 + eps) & (t >= eps) & (t < draw)
              & (sl_tri[:, None, :] >= 0))
        t = torch.where(ok, t, torch.inf)
        tmin, amin = t.min(dim=2)
        found = torch.isfinite(tmin)
        tri_out.append(torch.where(found, sl_tri.gather(1, amin), -1))
        t_out.append(torch.where(found, tmin, draw))
    return _hit(torch.cat(t_out), torch.cat(tri_out).to(torch.int32), meta,
                res_h, res_w)


def intersect_clustered_pallas(o: torch.Tensor, d: torch.Tensor,
                               accel: ClusterAccel, config, res_h: int,
                               res_w: int) -> Hit:
    """The "pallas" path: frustum cull -> kernel K5 (every candidate,
    exact MT) -> untile."""
    th, tw = config.tile_h, config.tile_w
    k = min(config.max_candidates, accel.num_clusters)
    tiles, meta = _tile_rays(d, res_h, res_w, th, tw)       # (nT, P, 3)
    cand, count, _, boxes = _cull(o, tiles, accel, config, k, boxes=True)
    t_tiles, tri_tiles, _ = tile_intersect(
        tiles.transpose(1, 2).contiguous(), cand, count, boxes,
        o.contiguous(), accel.geom9, accel.slot_mat, config.eps,
        config.draw_distance)
    return _hit(t_tiles, tri_tiles, meta, res_h, res_w)


def _root(o, accel: ClusterAccel) -> torch.Tensor:
    """K4's (9,) origin | root bmin | root bmax."""
    return torch.cat([o, accel.bounds_min.amin(dim=0),
                      accel.bounds_max.amax(dim=0)])


def _run_v2_kernel(o, d_tiles, cand, count, accel: ClusterAccel, config,
                   n_sub: int, boxes=None, root=None):
    """Cull output -> K4 -> (t (nT, P), tri (nT, P), steps (nT, 2)); the
    candidates' boxes and the root are made here unless given."""
    if boxes is None:
        boxes = _candidate_boxes(o, accel, cand, count)
    if root is None:
        root = _root(o, accel)
    return tile_intersect_v2(d_tiles, cand, count, boxes, root, accel.geom9,
                             accel.slot_mat, config.eps,
                             config.draw_distance, n_sub=n_sub,
                             count_subs=config.debug_mode == 1)


@dataclasses.dataclass
class EscalateBudget(Budget):
    """The bucket of "pallas2"'s exact escalation (``escalate_all``) inside
    `utils/graphs.py` `sized`: (tiles escalated, candidates a tile), and
    each object's live counts, an i64 (2,) [tiles with overflow, the
    longest visible list of an escalated tile with overflow], and their
    elementwise maximum."""

    def fill(self) -> tuple[list[int], int]:
        """Each object's tiles with overflow and the tiles' bucket."""
        return [int(n[0]) for n in self.counts], self.capacity[0]


def _v2_cull(o, d, accel: ClusterAccel, config, res_h: int, res_w: int,
             boxes: bool = False):
    """The "pallas2" tiles and their first cull: (tiles, meta, n_sub, cand,
    count, overflow), and with ``boxes`` the candidates' boxes."""
    th, tw = config.tile_h, config.tile_w
    k = min(config.max_candidates, accel.num_clusters)
    tiles, meta = _tile_rays(d, res_h, res_w, th, tw, config.sub_h,
                             config.sub_w)
    sh, sw = meta[6], meta[7]
    n_sub = (th // sh) * (tw // sw) if (sh and sw) else 1
    return (tiles, meta, n_sub,
            *_cull(o, tiles, accel, config, k, sh, sw, boxes))


def escalation_need(o: torch.Tensor, d: torch.Tensor, accel: ClusterAccel,
                    config, res_h: int, res_w: int) -> torch.Tensor:
    """The live counts that size "pallas2"'s exact escalation, an i64 (2,)
    on the device: the tiles whose first cull overflows, and the longest
    visible list among them (the flat cull's visible clusters; 0 where no
    tile overflows). The probe of a compiled frame's first bucket."""
    tiles, meta, _, _, _, overflow = _v2_cull(o, d, accel, config, res_h,
                                              res_w)
    over = overflow > 0
    if not bool(over.any()):                                # a host read
        return torch.zeros(2, dtype=torch.int64, device=o.device)
    _, count, ovf = cull_tiles(o, tiles[over], accel, config.tile_h,
                               config.tile_w, 1, meta[6], meta[7])
    return torch.stack([over.sum(), (count + ovf).amax().to(torch.int64)])


def intersect_clustered_pallas_v2(o: torch.Tensor, d: torch.Tensor,
                                  accel: ClusterAccel, config, res_h: int,
                                  res_w: int, bucket: tuple | None = None):
    """The "pallas2" path: frustum cull -> kernel K4 (nearest-first walk
    with the suffix-min early exit), then an exact second pass over the
    ``escalate_tiles`` tiles with the most overflow, flat-culled at
    ``max_candidates * escalate_factor`` and spliced in. The pass always
    runs (no host sync reads the overflow); overflow left after it is
    reported, not hidden.

    With ``config.escalate_all`` the second pass takes every tile with
    overflow, flat-culled at a budget that holds its whole visible list,
    so no tile keeps overflow: sized from the live counts (one host read)
    or, with ``bucket`` = (tiles, candidates), at that bucket with nothing
    read back. The result is then (Hit, the live counts of
    `escalation_need`, an i64 (2,) on the device): a caller that finds a
    count above its bucket must redo the frame at a larger one, so no
    result that is kept has dropped a cluster.

    With ``config.with_stats`` returns (Hit, stats): ``steps`` (nT,)
    candidates visited and ``mt_subs`` (nT,) sub-tile MT executions (with
    ``debug_mode`` 1, else 0) of the first pass, ``count`` (nT,) and
    ``overflow`` (nT,) after escalation.
    """
    th, tw = config.tile_h, config.tile_w
    k = min(config.max_candidates, accel.num_clusters)
    tiles, meta, n_sub, cand, count, overflow, boxes = _v2_cull(
        o, d, accel, config, res_h, res_w, boxes=True)
    sh, sw = meta[6], meta[7]
    root = _root(o, accel)
    t_tiles, tri_tiles, steps = _run_v2_kernel(
        o, tiles.transpose(1, 2).contiguous(), cand, count, accel, config,
        n_sub, boxes, root)

    n_tiles = tiles.shape[0]
    live = None
    if config.escalate_all:
        live = _escalate_all(o, tiles, overflow, t_tiles, tri_tiles, accel,
                             config, n_sub, sh, sw, bucket, root)
    else:
        e = min(config.escalate_tiles, n_tiles)
        k2 = min(k * max(config.escalate_factor, 1), accel.num_clusters)
        if e > 0 and k2 > k and accel.num_clusters > k:
            etile = torch.sort(overflow, descending=True,
                               stable=True).indices[:e]
            e_tiles = tiles[etile]
            cand2, count2, ovf2, boxes2 = cull_tiles(
                o, e_tiles, accel, th, tw, k2, sh, sw, boxes=True)
            t2, tri2, _ = _run_v2_kernel(
                o, e_tiles.transpose(1, 2).contiguous(), cand2, count2,
                accel, config, n_sub, boxes2, root)
            # escalated results are a superset of the first pass (a tile
            # picked with overflow 0 recomputes the same answer)
            t_tiles[etile] = t2
            tri_tiles[etile] = tri2
            overflow[etile] = ovf2

    hit = _hit(t_tiles, tri_tiles, meta, res_h, res_w)
    if config.with_stats:
        return hit, {"steps": steps[:, 0], "mt_subs": steps[:, 1],
                     "count": count, "overflow": overflow}
    if bucket is not None:
        return hit, live
    return hit


def _escalate_all(o, tiles, overflow, t_tiles, tri_tiles,
                  accel: ClusterAccel, config, n_sub: int, sh: int, sw: int,
                  bucket, root):
    """``escalate_all``'s second pass at ``bucket`` = (tiles, candidates),
    spliced into ``t_tiles``, ``tri_tiles`` and ``overflow`` in place;
    without a bucket at (the tiles with overflow, every cluster), one host
    read. Returns the live counts of `escalation_need` (None where no tile
    overflows and there is no bucket). Only tiles with overflow take its
    result, so the tiles a bucket adds change nothing."""
    over = overflow > 0
    if bucket is None:
        bucket = (int(over.sum()), accel.num_clusters)      # a host read
        if bucket[0] == 0:
            return None
    etile = torch.sort(overflow, descending=True,
                       stable=True).indices[:min(bucket[0], tiles.shape[0])]
    e_tiles = tiles[etile]
    cand2, count2, ovf2, boxes2 = cull_tiles(
        o, e_tiles, accel, config.tile_h, config.tile_w,
        min(bucket[1], accel.num_clusters), sh, sw, boxes=True)
    t2, tri2, _ = _run_v2_kernel(o, e_tiles.transpose(1, 2).contiguous(),
                                 cand2, count2, accel, config, n_sub, boxes2,
                                 root)
    took = over[etile]
    t_tiles[etile] = torch.where(took[:, None], t2, t_tiles[etile])
    tri_tiles[etile] = torch.where(took[:, None], tri2, tri_tiles[etile])
    overflow[etile] = torch.where(took, ovf2, overflow[etile])
    need = torch.where(took, count2 + ovf2, 0).amax()
    return torch.stack([over.sum(), need.to(torch.int64)])


def _ray_table(proj, o, bmin, bmax, n_tiles: int, n_tx: int,
               th: int, tw: int, draw_distance: float) -> torch.Tensor:
    """(n_tiles, th*tw, 4) f32 [dx | dy | dz | scene-exit bound] in
    row-major tile order, the rows counted from ``proj.row0`` of the frame.
    The bound is the far slab intersection with the object's root AABB
    (+1e-3), 0 when the ray misses the box; it is the comparand of the
    kernel's depth gate."""
    p = th * tw
    n = n_tiles * p
    idx = torch.arange(n, device=o.device)
    t = idx // p
    pi = idx - t * p
    ix = ((t % n_tx) * tw + pi % tw).to(torch.float32)
    iy = ((t // n_tx) * th + pi // tw + proj.row0).to(torch.float32)

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


def _bin_meta(config, res_h: int, res_w: int):
    """Untile metadata of the bin path's row-major tiles."""
    th, tw = config.tile_h, config.tile_w
    hp, wp = (-res_h) % th, (-res_w) % tw
    return (res_h + hp, res_w + wp, th, tw, hp, wp, 0, 0)


def bin_object(o: torch.Tensor, tris, proj, config, res_h: int, res_w: int,
               capacity: int | None = None
               ) -> tuple[torch.Tensor, BinnedScene]:
    """The kernel's operands for one object: the per-tile ray table and
    the binned entry table, at the image padded to whole tiles (with
    ``capacity`` entries: `bin_triangles`). The ray table is bounded by the
    root box that `bin_triangles`'s per-triangle pass reduces (K8 and its
    second launch on CUDA tensors, ``ops/cuda/bin_prepass.py``)."""
    h2, w2, th, tw = _bin_meta(config, res_h, res_w)[:4]
    n_tx = w2 // tw
    n_tiles = (h2 // th) * n_tx
    binned = bin_triangles(proj.band_local(), o,
                           (tris.p1x, tris.p1y, tris.p1z),
                           (tris.e1x, tris.e1y, tris.e1z),
                           (tris.e2x, tris.e2y, tris.e2z),
                           h2, w2, th, tw, chunk=config.bin_chunk,
                           eps=config.eps,
                           backface_cull=config.backface_cull,
                           capacity=capacity)
    rays = ray_table(proj, o, binned.bounds, n_tiles, n_tx, th, tw,
                     config.draw_distance)
    return rays, binned


def intersect_binned(o: torch.Tensor, d: torch.Tensor, tris, proj, config,
                     res_h: int, res_w: int, capacity: int | None = None):
    """Nearest hit per primary ray by screen-space binning + the
    bin-intersect kernel.

    ``proj`` is the camera Projection in the object's frame (of a band of
    rows when ``proj.row0`` > 0, whose rays are then bitwise the whole
    frame's) and ``o`` the object-frame origin. Primary rays only:
    directions are regenerated per tile from ``proj``, so ``d`` is ignored
    (it keeps the call shape of the other methods). The entry table is
    sized from the live count, so the JAX package's ``bin_e_factor`` /
    ``bin_escalate`` have nothing to do. With ``capacity`` it has that many
    entries and nothing is read back: the result is then (Hit, the live
    entry count, a scalar i64 on the device), and a caller that finds the
    count above the capacity must redo the frame at a larger one, so no
    result that is kept has dropped an entry (F3, F13).

    With ``config.with_stats`` the kernel runs its telemetry switch (K3,
    with ``config.bin_esub`` slices) and the result is (Hit, stats):
    ``steps`` (nT,) slices scanned and ``chunks`` (nT,) blocks walked per
    tile, ``entries`` (the live count), ``overflow`` (always 0: nothing is
    dropped) and ``cross`` (camera-plane-crossing triangles).
    """
    del d
    if config.sub_h or config.sub_w:
        raise ValueError("method='bin' generates rays in row-major tile "
                         "order; sub_h/sub_w are a cluster-path option")
    rays, binned = bin_object(o, tris, proj, config, res_h, res_w, capacity)
    out = bin_intersect(rays, binned.geom, binned.entry_tri, binned.starts,
                        config.bin_chunk, config.eps, config.draw_distance,
                        esub=config.bin_esub if config.with_stats else 1,
                        with_steps=config.with_stats)
    hit = _hit(out[0], out[1], _bin_meta(config, res_h, res_w), res_h, res_w)
    if config.with_stats:
        return hit, {"steps": out[2][:, 0], "chunks": out[2][:, 1],
                     "overflow": 0, "entries": binned.num_entries,
                     "cross": binned.cross_tris}
    if capacity is not None:
        return hit, binned.num_entries
    return hit


@dataclasses.dataclass
class KDTables:
    """The flattened KD tree (any leaf width) on the triangles' device,
    with the triangles' geometry permuted so that every leaf's triangles
    are contiguous (the reference's per-camera voxel tables,
    Camera.cu:137-162, in the object frame: rays are transformed instead).
    """

    bounds_min: torch.Tensor   # (N, 3) float32
    bounds_max: torch.Tensor   # (N, 3)
    axis: torch.Tensor         # (N,) int64 cut axis 0/1/2
    s1: torch.Tensor           # (N,) float32
    s2: torch.Tensor           # (N,)
    left: torch.Tensor         # (N,) int64, -1 at leaves
    right: torch.Tensor        # (N,)
    is_leaf: torch.Tensor      # (N,) bool
    leaf_start: torch.Tensor   # (N,) int64
    leaf_count: torch.Tensor   # (N,) int64
    p1: torch.Tensor           # (T, 3) permuted geometry, views of
    e1: torch.Tensor           # (T, 3)   slot_geom
    e2: torch.Tensor           # (T, 3)
    perm: torch.Tensor         # (T,) int32 original triangle ids
    node_box: torch.Tensor     # (N, 8) float32 (bmin, s1, bmax, s2): K7's
    node_link: torch.Tensor    # (N, 4) int32 (-1, leaf_start, leaf_count, 0)
    #                            at a leaf, (axis, left, right, 0) elsewhere
    slot_geom: torch.Tensor    # (T, 12) (p1, 0, e1, 0, e2, 0) in leaf
    #                            order, the geometry's dtype: K7's slots
    max_depth: int
    max_leaf: int

    @classmethod
    @torch.no_grad()
    @tally("kd_build_s")
    def from_tree(cls, tree: KDTree, tris) -> "KDTables":
        """Tables of ``tree`` (accel/kd_build.py, numpy) over ``tris``, on
        the triangles' device; its host seconds count in ``kd_build_s``
        (`utils/profiling.py`)."""
        dev = tris.p1x.device
        perm = torch.from_numpy(np.asarray(tree.perm, np.int64)).to(dev)

        def t(x, dtype=None):
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev, dtype)
        leaf = np.asarray(tree.is_leaf)
        zero = np.zeros(leaf.shape, np.int64)
        link = np.stack([np.where(leaf, -1, tree.cut_code % 3),
                         np.where(leaf, tree.leaf_start, tree.left),
                         np.where(leaf, tree.leaf_count, tree.right), zero],
                        axis=1)
        box = np.concatenate([tree.bounds_min, tree.s1[:, None],
                              tree.bounds_max, tree.s2[:, None]], axis=1)
        pad = tris.p1.new_zeros((perm.shape[0], 1))
        slot_geom = torch.cat([tris.p1[perm], pad, tris.e1[perm], pad,
                               tris.e2[perm], pad], dim=1)
        p1, e1, e2 = (slot_geom[:, k:k + 3] for k in (0, 4, 8))
        return cls(bounds_min=t(tree.bounds_min),
                   bounds_max=t(tree.bounds_max),
                   axis=t(tree.cut_code % 3, torch.int64), s1=t(tree.s1),
                   s2=t(tree.s2), left=t(tree.left, torch.int64),
                   right=t(tree.right, torch.int64), is_leaf=t(tree.is_leaf),
                   leaf_start=t(tree.leaf_start, torch.int64),
                   leaf_count=t(tree.leaf_count, torch.int64),
                   p1=p1, e1=e1, e2=e2, perm=perm.to(torch.int32),
                   node_box=t(box, torch.float32),
                   node_link=t(link, torch.int32), slot_geom=slot_geom,
                   max_depth=int(tree.max_depth),
                   max_leaf=int(tree.leaf_count.max()))


def kd_intersect(o: torch.Tensor, d: torch.Tensor, tables: KDTables,
                 draw_distance: float = DEFAULT_DRAW_DISTANCE,
                 eps: float = MT_EPSILON, ray_chunk: int = 32768,
                 width: int = 0) -> Hit:
    """The nearest hit of each ray over the KD tree, the reference's stack
    traversal (Trixel.cu:41-172) with the near-first exit, which changes no
    t and no id except possibly on a hit within about 6e-3 radians of its
    triangle's plane in float32 (1e-11 in float64; `NEAR_REL` in
    ``ops/cuda/kd_traverse.py``): on CUDA tensors kernel K7 (that module,
    one thread a ray, its own stack; no host read, so `render_jit` and
    `make_train_step_jit` capture it), on CPU tensors `kd_intersect_plain`.
    The two agree bit for bit in t and ids. ``ray_chunk`` is the plain
    version's and ``width`` (the rays are rows of an image that wide) the
    kernel's; neither changes a result."""
    t, tri = kd_traverse(o, d, tables, draw_distance, eps, ray_chunk, width)
    return Hit(t=t, tri=tri, obj=torch.where(tri >= 0, 0, -1).to(torch.int32))


def kd_intersect_plain(o: torch.Tensor, d: torch.Tensor, tables: KDTables,
                       draw_distance: float = DEFAULT_DRAW_DISTANCE,
                       eps: float = MT_EPSILON, ray_chunk: int = 32768,
                       near_first: bool = True) -> Hit:
    """`kd_intersect` by the plain PyTorch version on any device: the
    traversal in lockstep over rays, a host read a step
    (``ops/cuda/kd_traverse.py`` `kd_traverse_reference`), in runs of
    ``ray_chunk`` rays (0: all at once), which change no result. K7's
    oracle; ``near_first=False`` walks without the exit (JAX's loop), the
    oracle of the exit's exactness.

    Against JAX's ``kd_intersect`` (ROADMAP F15): both walks give JAX's ids
    on hits at least 3e-3 rad off their triangle's plane in float32
    (tests/test_torch_kd.py, tilted planes); closer to the plane MT's t
    loses its digits and another operation order picks other ids (1-2
    rays of 1,500 at 1e-3 rad, 27-54 at 1e-4, 213-453 at 1e-5)."""
    t, tri = kd_traverse_reference(o, d, tables, draw_distance, eps,
                                   ray_chunk, near_first=near_first)
    return Hit(t=t, tri=tri, obj=torch.where(tri >= 0, 0, -1).to(torch.int32))
