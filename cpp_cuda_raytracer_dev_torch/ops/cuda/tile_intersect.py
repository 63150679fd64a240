"""Tile-intersect: the nearest hit per primary ray over a tile's candidate
clusters, kernels K4 (``method="pallas2"``, the JAX package's
``ops/pallas/intersect_kernel_v2.py``) and K5 (``method="pallas"``,
``ops/pallas/intersect_kernel.py``), and the cull that lists those
candidates, kernel K14 (`cluster_cull`; its plain twin is
``accel/traverse.py``'s, which dispatches by device).

- `tile_intersect_v2` (K4) and `tile_intersect` (K5) are the wrappers. For
  CUDA tensors they launch the hand-written kernel in
  ``csrc/tile_intersect.cu`` and raise if the launch fails; for CPU tensors
  they run `tile_intersect_v2_reference` / `tile_intersect_reference`.
  Nothing falls back from the card to the plain version.
- The plain versions have the same contract (stated in the CUDA source):
  they step the candidate index k for all tiles at once (in tile groups to
  bound memory), apply the same per-ray gate and, for K4, the same
  per-tile exit at each k, and agree with the kernels bit for bit.
- ``.launches`` on each wrapper counts kernel launches; inside a captured
  CUDA graph (`render_jit`) that is the capture's launch, not the
  replays' (chip_smoke.py counts a replay's kernels in the profiler).
- K14 (`cluster_cull`, CUDA tensors only) culls every tile of one pass
  in one launch and writes its candidate list, count, overflow and,
  optionally, the candidates' boxes, at any cluster count. The contract is
  stated in ``csrc/tile_intersect.cu``; ``cluster_cull.launches`` counts
  its launches.
- The kernels take P <= 2048 rays a tile (a multiple of 32, and above 512
  of 512), n_sub <= 2048 and eps > 0; the wrappers raise otherwise.

Operands, as the JAX kernels take them: ``d_tiles`` (nT, 3, P) unit
directions in the object frame; ``cand`` (nT, K) int32 cluster ids nearest
first; ``count`` (nT,) int32 valid candidates; ``boxes`` (nT, K, 8) the
candidates' AABBs (bmin | bmax) with, for K4, the suffix-min
origin-to-AABB distance in column 6; ``root`` (9,) origin | root bmin |
root bmax (K5 reads only the origin); ``geom9`` (C, 9, Lpad) slot geometry
rows p1 | e1 | e2 (zero padding); ``slot_mat`` (C, L) int32 triangle ids,
-1 on padding slots. Both return (t (nT, P) f32, draw distance on a miss;
tri (nT, P) i32, -1 on a miss; steps (nT, 2) i32 = [candidates visited,
sub-tile MT executions]). ``n_sub`` splits each tile's P rays into
contiguous sub-tiles for the second count, which is taken only with
``count_subs`` (the JAX package's ``debug_mode`` 1); it never changes a hit.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...utils.dtypes import DEFAULT_DRAW_DISTANCE, MT_EPSILON
from . import _build

_MISS_T = 3.0e38          # K4's t of a rejected slot
_I32_MAX = torch.iinfo(torch.int32).max
_PAIRS = 1 << 24          # ray-slot pairs per group of the plain versions
_THREADS = 512            # the kernels' largest CTA
_MAX_RAYS = 2048          # 4 rays a thread
_MAX_SUB = 2048
_MAX_SLOTS = 1024
_PREFETCH = 3             # candidates whose geometry is in flight
_LONGEST_FIRST_TILES = 512  # order the tiles by count from this many on
_CULL_BLOCKS_PER_SM = 2  # K14's CTAs an SM where it sorts in global scratch
_fn = []
_cull_fn = []


def _launcher():
    if not _fn:
        fn = _build.load("tile_intersect").tile_intersect_launch
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 10
                       + [ctypes.c_float] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn.append(fn)
    return _fn[0]


def _constants(eps: float, draw_distance: float):
    """eps, 1 - eps, ((1 - eps) eps)² and the draw distance rounded to
    float32, as the JAX kernels' weakly typed Python constants are
    (intersect_kernel_v2.py:181-183)."""
    k1 = 1.0 - eps
    return tuple(float(np.float32(x)) for x in
                 (eps, k1, (k1 * eps) ** 2, draw_distance))


def _check(d_tiles, cand, count, boxes, root, geom9, slot_mat, n_sub):
    if d_tiles.dim() != 3 or d_tiles.shape[1] != 3 \
            or d_tiles.dtype != torch.float32:
        raise ValueError(f"d_tiles must be (nT, 3, P) float32, got "
                         f"{tuple(d_tiles.shape)} {d_tiles.dtype}")
    n_t, _, p = d_tiles.shape
    if cand.dim() != 2 or cand.shape[0] != n_t or cand.dtype != torch.int32 \
            or cand.shape[1] < 1:
        raise ValueError("cand must be (nT, K >= 1) int32")
    kmax = cand.shape[1]
    if count.shape != (n_t,) or count.dtype != torch.int32:
        raise ValueError("count must be (nT,) int32")
    if boxes.shape != (n_t, kmax, 8) or boxes.dtype != torch.float32:
        raise ValueError("boxes must be (nT, K, 8) float32")
    if root.dim() != 1 or root.shape[0] not in (3, 9) \
            or root.dtype != torch.float32:
        raise ValueError("root must be (9,) or, for K5, (3,) float32")
    if geom9.dim() != 3 or geom9.shape[1] != 9 \
            or geom9.dtype != torch.float32:
        raise ValueError("geom9 must be (C, 9, Lpad) float32")
    if slot_mat.dim() != 2 or slot_mat.shape[0] != geom9.shape[0] \
            or slot_mat.shape[1] > geom9.shape[2] \
            or slot_mat.dtype != torch.int32:
        raise ValueError("slot_mat must be (C, L <= Lpad) int32")
    if n_sub < 1 or p % n_sub:
        raise ValueError(f"P = {p} rays per tile not divisible by "
                         f"n_sub = {n_sub}")
    for name, x in (("d_tiles", d_tiles), ("cand", cand), ("count", count),
                    ("boxes", boxes), ("root", root), ("geom9", geom9),
                    ("slot_mat", slot_mat)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != d_tiles.device:
            raise ValueError(f"{name} is on {x.device}, d_tiles on "
                             f"{d_tiles.device}")


def _launch(gen, d_tiles, cand, count, boxes, root, geom9, slot_mat, eps,
            draw_distance, n_sub, count_subs, *, levers=0,
            prefetch=_PREFETCH, longest_first=None):
    """Launch K4 (gen 4) or K5 (gen 5). ``levers`` (bit 0: every slot, no
    fill cut; bit 1: no compaction of the rays past a box test; bit 2 /
    bit 3: one / four rays a thread in the slot loop), ``prefetch``
    (candidates in flight, 0-3) and ``longest_first`` (None: from
    `_LONGEST_FIRST_TILES` tiles on) exist to measure each design lever
    against its absence; no caller of the wrappers sets them."""
    if d_tiles.device.type != "cuda":
        raise ValueError(f"no tile_intersect kernel for {d_tiles.device}")
    n_t, _, p = d_tiles.shape
    threads = min(p, _THREADS)
    if p % 32 or p % threads or p > _MAX_RAYS:
        raise ValueError(f"P = {p} rays per tile must be a multiple of 32 "
                         f"and, above {_THREADS}, of {_THREADS}, at most "
                         f"{_MAX_RAYS}")
    if n_sub > _MAX_SUB:
        raise ValueError(f"n_sub {n_sub} above {_MAX_SUB}")
    n_slots = slot_mat.shape[1]
    if not 1 <= n_slots <= _MAX_SLOTS:
        raise ValueError(f"L = {n_slots} slots a cluster, at most "
                         f"{_MAX_SLOTS}")
    if not eps > 0.0:
        raise ValueError(f"the kernels need eps > 0, got {eps}")
    dev = d_tiles.device
    out_t = torch.empty((n_t, p), dtype=torch.float32, device=dev)
    out_tri = torch.empty((n_t, p), dtype=torch.int32, device=dev)
    steps = torch.empty((n_t, 2), dtype=torch.int32, device=dev)
    if n_t == 0:
        return out_t, out_tri, steps
    if longest_first is None:
        longest_first = n_t >= _LONGEST_FIRST_TILES
    order = (torch.empty(n_t, dtype=torch.int32, device=dev)
             if longest_first else None)
    eps_f, k1, eps2_det, draw = _constants(eps, draw_distance)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _launcher()(d_tiles.data_ptr(), cand.data_ptr(), count.data_ptr(),
                      boxes.data_ptr(), root.data_ptr(), geom9.data_ptr(),
                      slot_mat.data_ptr(),
                      None if order is None else order.data_ptr(),
                      out_t.data_ptr(), out_tri.data_ptr(), steps.data_ptr(),
                      n_t, p, cand.shape[1], n_slots, geom9.shape[2], n_sub,
                      gen, int(count_subs), levers, prefetch, eps_f, k1,
                      eps2_det, draw, stream)
    if err != 0:
        raise RuntimeError(f"tile_intersect (K{gen}) kernel launch failed: "
                           f"CUDA error {err}")
    return out_t, out_tri, steps


def tile_intersect_v2(d_tiles: torch.Tensor, cand: torch.Tensor,
                      count: torch.Tensor, boxes: torch.Tensor,
                      root: torch.Tensor, geom9: torch.Tensor,
                      slot_mat: torch.Tensor, eps: float = MT_EPSILON,
                      draw_distance: float = DEFAULT_DRAW_DISTANCE,
                      n_sub: int = 1, count_subs: bool = False):
    """K4: nearest hit per ray with the root-box bound and the suffix-min
    early exit (operands and outputs in the module docstring)."""
    _check(d_tiles, cand, count, boxes, root, geom9, slot_mat, n_sub)
    if root.shape[0] != 9:
        raise ValueError("K4 needs root = origin | root bmin | root bmax")
    if d_tiles.device.type == "cpu":
        return tile_intersect_v2_reference(d_tiles, cand, count, boxes, root,
                                           geom9, slot_mat, eps,
                                           draw_distance, n_sub, count_subs)
    out = _launch(4, d_tiles, cand, count, boxes, root, geom9, slot_mat,
                  eps, draw_distance, n_sub, count_subs)
    tile_intersect_v2.launches += 1
    return out


tile_intersect_v2.launches = 0


def tile_intersect(d_tiles: torch.Tensor, cand: torch.Tensor,
                   count: torch.Tensor, boxes: torch.Tensor,
                   origin: torch.Tensor, geom9: torch.Tensor,
                   slot_mat: torch.Tensor, eps: float = MT_EPSILON,
                   draw_distance: float = DEFAULT_DRAW_DISTANCE,
                   n_sub: int = 1, count_subs: bool = False):
    """K5: nearest hit per ray over every candidate k < count, exact MT,
    lowest triangle id on a tie (operands and outputs in the module
    docstring; ``origin`` is (3,), or a (9,) root whose first three are
    the origin)."""
    _check(d_tiles, cand, count, boxes, origin, geom9, slot_mat, n_sub)
    if d_tiles.device.type == "cpu":
        return tile_intersect_reference(d_tiles, cand, count, boxes, origin,
                                        geom9, slot_mat, eps, draw_distance,
                                        n_sub, count_subs)
    out = _launch(5, d_tiles, cand, count, boxes, origin, geom9, slot_mat,
                  eps, draw_distance, n_sub, count_subs)
    tile_intersect.launches += 1
    return out


tile_intersect.launches = 0


def _slot_constants(origin, geom9, n_slots, fold, eps_f, k1):
    """(10, C, L) per-slot constants m_det | m_u | m_v | td for rays from
    ``origin`` (the kernels' staging step, the same operations in the same
    order); with ``fold`` (K4) the eps folding."""
    g = geom9[:, :, :n_slots]
    p1x, p1y, p1z, e1x, e1y, e1z, e2x, e2y, e2z = g.unbind(1)
    ox, oy, oz = origin[0], origin[1], origin[2]
    tvx, tvy, tvz = ox - p1x, oy - p1y, oz - p1z
    mdx = e2y * e1z - e2z * e1y
    mdy = e2z * e1x - e2x * e1z
    mdz = e2x * e1y - e2y * e1x
    mux = e2y * tvz - e2z * tvy
    muy = e2z * tvx - e2x * tvz
    muz = e2x * tvy - e2y * tvx
    mvx = tvy * e1z - tvz * e1y
    mvy = tvz * e1x - tvx * e1z
    mvz = tvx * e1y - tvy * e1x
    td = e2x * mvx + e2y * mvy + e2z * mvz
    if fold:
        m = (mdx * k1, mdy * k1, mdz * k1,
             mux - eps_f * mdx, muy - eps_f * mdy, muz - eps_f * mdz,
             mvx - eps_f * mdx, mvy - eps_f * mdy, mvz - eps_f * mdz,
             td * k1)
    else:
        m = (mdx, mdy, mdz, mux, muy, muz, mvx, mvy, mvz, td)
    return torch.stack(m)


def _inv_dirs(d_tiles):
    """Per-ray reciprocal directions (nT, P) x 3, with the 1e-30 clamp."""
    out = []
    for dax in d_tiles.unbind(1):
        dsf = torch.where(dax.abs() < 1e-30,
                          torch.where(dax < 0, -1e-30, 1e-30), dax)
        out.append(torch.reciprocal(dsf))
    return out


def _slab(lo, hi, o, inv):
    """(t_near, t_far) of rays with reciprocal directions ``inv`` (3 of
    (n, P)) against boxes lo/hi (3 of (n, 1)) from origin ``o``."""
    ta = [(lo[a] - o[a]) * inv[a] for a in range(3)]
    tb = [(hi[a] - o[a]) * inv[a] for a in range(3)]
    t_near = torch.maximum(torch.maximum(torch.minimum(ta[0], tb[0]),
                                         torch.minimum(ta[1], tb[1])),
                           torch.minimum(ta[2], tb[2]))
    t_far = torch.minimum(torch.minimum(torch.maximum(ta[0], tb[0]),
                                        torch.maximum(ta[1], tb[1])),
                          torch.maximum(ta[2], tb[2]))
    return t_near, t_far


def _root_bound(root, inv, draw):
    t_near, t_far = _slab([root[3 + a] for a in range(3)],
                          [root[6 + a] for a in range(3)], root[:3], inv)
    root_hit = t_far >= torch.clamp_min(t_near, 0.0) - 1e-4
    return torch.clamp_max(torch.where(root_hit, t_far + 1e-3, 0.0), draw)


def _walk(gen, d_tiles, cand, count, boxes, root, geom9, slot_mat, eps,
          draw_distance, n_sub, count_subs):
    """The plain versions' shared walk over candidate index k."""
    v2 = gen == 4
    eps_f, k1, eps2_det, draw = _constants(eps, draw_distance)
    n_t, _, p = d_tiles.shape
    kmax, n_slots = cand.shape[1], slot_mat.shape[1]
    dev = d_tiles.device
    o = root[:3]
    d = d_tiles.unbind(1)
    inv = _inv_dirs(d_tiles)
    bound = (_root_bound(root, inv, draw) if v2 else
             torch.full((n_t, p), draw, dtype=torch.float32, device=dev))
    cst = _slot_constants(o, geom9, n_slots, v2, eps_f, k1)  # (10, C, L)
    best_t = torch.full((n_t, p), draw, dtype=torch.float32, device=dev)
    best_tri = torch.full((n_t, p), -1, dtype=torch.int32, device=dev)
    visited = torch.zeros(n_t, dtype=torch.int32, device=dev)
    n_mt = torch.zeros(n_t, dtype=torch.int32, device=dev)
    wb = bound.amax(dim=1)
    alive = torch.ones(n_t, dtype=torch.bool, device=dev)
    slot_iota = torch.arange(n_slots, dtype=torch.int64, device=dev)
    cand_l = cand.long()
    group = max(1, _PAIRS // (p * n_slots))
    for k in range(kmax):
        alive &= k < count
        if v2:
            alive &= boxes[:, k, 6] < wb
        tiles_k = torch.nonzero(alive).squeeze(1)
        if tiles_k.numel() == 0:
            break
        visited[tiles_k] += 1
        for i in range(0, tiles_k.shape[0], group):
            tg = tiles_k[i:i + group]
            box = boxes[tg, k]                                   # (n, 8)
            inv_g = [x[tg] for x in inv]
            t_near, t_far = _slab([box[:, a, None] for a in range(3)],
                                  [box[:, 3 + a, None] for a in range(3)],
                                  o, inv_g)
            cur_t, cur_tri = best_t[tg], best_tri[tg]
            lim = torch.minimum(cur_t, bound[tg]) if v2 else cur_t
            box_ok = (t_far >= torch.clamp_min(t_near, 0.0) - 1e-4) & \
                     (t_near < lim)                              # (n, P)
            if count_subs:
                n_mt[tg] += box_ok.view(-1, n_sub, p // n_sub).any(
                    dim=2).sum(dim=1, dtype=torch.int32)
            c = cand_l[tg, k]
            m = cst[:, c, None, :]                         # (10, n, 1, L)
            dx, dy, dz = (x[tg][..., None] for x in d)           # (n, P, 1)
            det = dx * m[0] + dy * m[1] + dz * m[2]              # (n, P, L)
            up = dx * m[3] + dy * m[4] + dz * m[5]
            vp = dx * m[6] + dy * m[7] + dz * m[8]
            td = m[9]
            ids = slot_mat[c]                                    # (n, L)
            if v2:
                dd2 = det * det
                q = torch.minimum(up * det, vp * det)
                q = torch.minimum(q, (det - up - vp) * det)
                q = torch.minimum(q, td * det - eps_f * dd2)
                ok = (q >= 0.0) & (dd2 >= eps2_det)
                tt = torch.where(ok, td / det, _MISS_T)
                tmin = tt.amin(dim=2)
                slot = torch.where(tt == tmin[..., None], slot_iota,
                                   n_slots).amin(dim=2)
                tri = ids.gather(1, slot.clamp_max(n_slots - 1))
            else:
                s = torch.where(det >= 0.0, 1.0, -1.0)
                ad, uds, vds = det * s, up * s, vp * s
                eps_ad = eps_f * ad
                tt = td * torch.reciprocal(det)
                ok = ((ad >= eps_f) & (uds >= eps_ad) & (vds >= eps_ad)
                      & (uds + vds <= ad + eps_ad) & (tt >= eps_f)
                      & (ids[:, None, :] >= 0))
                tt = torch.where(ok, tt, draw)
                tmin = tt.amin(dim=2)
                tri = torch.where(tt <= tmin[..., None], ids[:, None, :],
                                  _I32_MAX).amin(dim=2)
            better = box_ok & (tmin < cur_t)
            if v2:
                # the kernel takes only slots with t below _MISS_T, so an
                # unaccepted cluster never wins at a draw distance above it
                better &= tmin < _MISS_T
            best_t[tg] = torch.where(better, tmin, cur_t)
            best_tri[tg] = torch.where(better, tri, cur_tri)
        if v2:
            wb[tiles_k] = torch.minimum(
                wb[tiles_k],
                torch.minimum(best_t[tiles_k], bound[tiles_k]).amax(dim=1))
    return best_t, best_tri, torch.stack([visited, n_mt], dim=1)


def tile_intersect_v2_reference(d_tiles, cand, count, boxes, root, geom9,
                                slot_mat, eps: float = MT_EPSILON,
                                draw_distance: float = DEFAULT_DRAW_DISTANCE,
                                n_sub: int = 1, count_subs: bool = False):
    """Plain PyTorch version of `tile_intersect_v2` (same contract, same
    result bit for bit)."""
    return _walk(4, d_tiles, cand, count, boxes, root, geom9, slot_mat, eps,
                 draw_distance, n_sub, count_subs)


def tile_intersect_reference(d_tiles, cand, count, boxes, origin, geom9,
                             slot_mat, eps: float = MT_EPSILON,
                             draw_distance: float = DEFAULT_DRAW_DISTANCE,
                             n_sub: int = 1, count_subs: bool = False):
    """Plain PyTorch version of `tile_intersect` (same contract, same
    result bit for bit)."""
    return _walk(5, d_tiles, cand, count, boxes, origin, geom9, slot_mat,
                 eps, draw_distance, n_sub, count_subs)


def _cull_launcher():
    if not _cull_fn:
        lib = _build.load("tile_intersect")
        fn = lib.cluster_cull_launch
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 10
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        scratch = lib.cluster_cull_scratch
        scratch.argtypes = [ctypes.c_int] * 3
        scratch.restype = ctypes.c_size_t
        _cull_fn.append((fn, scratch))
    return _cull_fn[0]


def _check_cuda_f32(dev, **operands):
    for name, x in operands.items():
        if x.device != dev or x.device.type != "cuda":
            raise ValueError(f"{name} is on {x.device}: K14 takes CUDA "
                             f"tensors on one device")
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32, got "
                             f"{x.dtype}")


def cluster_cull(origin: torch.Tensor, tiles: torch.Tensor,
                 center: torch.Tensor, bounds_min: torch.Tensor,
                 bounds_max: torch.Tensor, corners: tuple, k: int,
                 group: int = 0, kg: int = 0, with_boxes: bool = True):
    """K14: one cull pass over every tile in one launch. ``tiles`` (nT, P,
    3) directions, ``center`` (nT, 3) their mean over P, ``corners`` the
    P-axis positions (0, i01, i10, i11) of the corner rays; ``group`` > 0
    culls through groups of that many clusters, the ``kg`` nearest (kg <=
    the number of groups), else every cluster. Returns (cand (nT, k) int32,
    count (nT,) int32, overflow (nT,) int32, boxes (nT, k, 8) float32 or
    None), bitwise `accel/traverse.py`'s twin. A level of more than 16,384
    positions sorts in a global scratch buffer allocated here, a
    workspace for each of `_CULL_BLOCKS_PER_SM` CTAs an SM."""
    dev = origin.device
    _check_cuda_f32(dev, origin=origin, tiles=tiles, center=center,
                    bounds_min=bounds_min, bounds_max=bounds_max)
    if origin.shape != (3,):
        raise ValueError(f"origin must be (3,), got {tuple(origin.shape)}")
    if bounds_min.dim() != 2 or bounds_min.shape[1] != 3 \
            or bounds_max.shape != bounds_min.shape:
        raise ValueError("bounds_min / bounds_max must be (C, 3)")
    if tiles.dim() != 3 or tiles.shape[2] != 3 \
            or center.shape != (tiles.shape[0], 3):
        raise ValueError("tiles must be (nT, P, 3) and center (nT, 3)")
    n_t, p = tiles.shape[:2]
    c = bounds_min.shape[0]
    i00, i01, i10, i11 = corners
    if i00 != 0 or not all(0 <= i < p for i in (i01, i10, i11)):
        raise ValueError(f"corner positions {corners} outside P = {p}")
    ng = -(-c // group) if group > 0 else 0
    if group > 0:
        if not (1 <= kg <= ng and 1 <= k <= kg * group):
            raise ValueError(f"k = {k}, kg = {kg}: need 1 <= kg <= {ng} "
                             f"groups and 1 <= k <= kg x group")
    elif not 1 <= k <= c:
        raise ValueError(f"k = {k} outside 1..{c} clusters")
    cand = torch.empty((n_t, k), dtype=torch.int32, device=dev)
    count = torch.empty(n_t, dtype=torch.int32, device=dev)
    overflow = torch.empty(n_t, dtype=torch.int32, device=dev)
    boxes = (torch.empty((n_t, k, 8), dtype=torch.float32, device=dev)
             if with_boxes else None)
    if not n_t:
        return cand, count, overflow, boxes
    gbox = (torch.empty((ng, 6), dtype=torch.float32, device=dev)
            if group > 0 else None)
    launch, scratch_bytes = _cull_launcher()
    per_block = scratch_bytes(c, group, kg)
    blocks, scratch = 0, None
    if per_block:
        blocks = min(n_t, _CULL_BLOCKS_PER_SM * torch.cuda
                     .get_device_properties(dev).multi_processor_count)
        scratch = torch.empty(blocks * per_block, dtype=torch.uint8,
                              device=dev)
    err = launch(tiles.data_ptr(), center.data_ptr(), origin.data_ptr(),
                 bounds_min.data_ptr(), bounds_max.data_ptr(),
                 None if gbox is None else gbox.data_ptr(), cand.data_ptr(),
                 count.data_ptr(), overflow.data_ptr(),
                 None if boxes is None else boxes.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), blocks,
                 n_t, p, c, k, group, kg, i01, i10, i11,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cluster_cull (K14) launch failed: CUDA error "
                           f"{err}")
    cluster_cull.launches += 1
    return cand, count, overflow, boxes


cluster_cull.launches = 0
