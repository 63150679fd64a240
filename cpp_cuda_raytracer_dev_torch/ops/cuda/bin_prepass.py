"""The bin path's prepass: kernels K8 and K9 (``csrc/bin_prepass.cu``), the
counterparts of the JAX package's XLA-fused plain code in ``bin_triangles``
(``accel/binning.py``) and ``intersect_binned``'s root box and ray table
(``accel/traverse.py``); not Pallas kernels.

`accel/binning.py` `bin_triangles` runs, per object and frame:

1. `bin_tri_pass` (K8): one thread a triangle projects it, tests it, bins
   it to a tile range and writes its MT constants; the root box, the depth
   range and the crosser count reduce over all triangles;
2. ``torch.cumsum`` of the tile counts (a library scan, as in JAX);
3. `bin_entry_keys` (K9a): each triangle writes its entries' (tile, depth
   bucket) keys and ids, and the dead slots of a capacity bucket their key;
4. ``torch.sort(key, stable=True)`` (JAX's ``lax.sort``, a library sort);
5. `bin_entry_table` (K9b): the MT table (11, E_pad) in entry order, the
   entry ids, the dead chunk and the tile starts;

and `accel/traverse.py` `bin_object` adds `ray_table` (K8's second launch),
the per-tile ray rows bounded by the root box.

Each wrapper launches its kernel for CUDA tensors and raises if the launch
fails or an operand is not one it takes; for CPU tensors it runs its plain
version (`bin_tri_pass_reference`, ``accel/traverse.py`` `_ray_table`,
`bin_entry_keys_reference`, `bin_entry_table_reference`: today's plain code,
split at the kernels' boundaries). Nothing falls back from the card to the
plain versions. The kernels and their plain versions agree bit for bit.
Each wrapper counts its launches in ``.launches``; inside a captured CUDA
graph that is the capture's launch, not the replays'.

An object with no triangles bins nothing: its root box is (+inf, -inf) and
its depth range (+inf, -inf), the identities of the reductions (``amin``
refuses an empty tensor).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import _build
from .bin_intersect import GEOM_ROWS

BIG = 3.0e38
_fn = []


@dataclasses.dataclass
class TriPass:
    """K8's per-triangle output (float32 and int; T triangles)."""

    ntiles: torch.Tensor      # (T,) i64 tiles the triangle bins to
    tinfo: torch.Tensor       # (T, 3) i32 tiles across, first tile x, y
    ftab: torch.Tensor        # (T, 11) f32 MT constants | depth certificate
    stats: torch.Tensor       # (8,) f32 root box min xyz, max xyz, d_lo, d_hi
    cross_tris: torch.Tensor  # () i64 camera-plane-crossing triangles


def _lib():
    if not _fn:
        lib = _build.load("bin_prepass")
        ptr, i32, i64, f64 = (ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_longlong, ctypes.c_double)
        lib.bin_tri_pass_launch.argtypes = (
            [i32, ptr, ptr, ptr] + [i32] * 5 + [f64] * 2 + [ptr] * 9)
        lib.ray_table_launch.argtypes = [i32] * 6 + [ptr] * 3 + [f64] \
            + [ptr] * 2
        lib.entry_keys_launch.argtypes = [i32] + [ptr] * 5 + [i32] * 3 \
            + [i64] + [ptr] * 4
        lib.entry_table_launch.argtypes = [i64, i64] + [i32] * 3 \
            + [ptr] * 8
        for f in ("bin_tri_pass_launch", "ray_table_launch",
                  "entry_keys_launch", "entry_table_launch"):
            getattr(lib, f).restype = ctypes.c_int
        lib.bin_prepass_threads.restype = ctypes.c_int
        _fn.append(lib)
    return _fn[0]


def _raise(name, err):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


_PROJ_FIELDS = ("origin", "n", "u", "v", "sx", "sy", "adjust_x", "adjust_y")


def _proj_tensors(proj, dev):
    """The Projection's eight fields, float32 and contiguous on ``dev``."""
    out = []
    for f in _PROJ_FIELDS:
        x = getattr(proj, f)
        want = (3,) if f in ("origin", "n", "u", "v") else ()
        if x.shape != want or x.dtype != torch.float32 or x.device != dev:
            raise ValueError(f"proj.{f} must be {want} float32 on {dev}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
        out.append(x.contiguous())
    return out


def _mt_scalars(eps):
    """1 - eps and eps rounded to float32, as the plain version takes them."""
    f32 = torch.float32
    return (float(torch.tensor(1.0 - eps, dtype=f32)),
            float(torch.tensor(eps, dtype=f32)))


def _amin(x):
    return x.amin() if x.numel() else x.new_full((), float("inf"))


def _amax(x):
    return x.amax() if x.numel() else x.new_full((), -float("inf"))


# ---- K8: the per-triangle pass ----

def bin_tri_pass(proj, origin: torch.Tensor, p1, e1, e2, res_h: int,
                 res_w: int, th: int, tw: int, eps: float,
                 backface_cull: bool) -> TriPass:
    """K8 over object-frame triangles (p1, e1, e2: (x, y, z) tuples of flat
    (T,) float32 tensors) seen through ``proj`` from ``origin`` (3,), at a
    (res_h x res_w) image of (th x tw) tiles."""
    leaves = [*p1, *e1, *e2]
    dev = origin.device
    t_n = leaves[0].shape[0]
    for x in leaves:
        if x.shape != (t_n,) or x.dtype != torch.float32 or x.device != dev \
                or not x.is_contiguous():
            raise ValueError(f"the leaves must be contiguous ({t_n},) "
                             f"float32 on {dev}, got {tuple(x.shape)} "
                             f"{x.dtype} on {x.device}")
    if origin.shape != (3,) or origin.dtype != torch.float32:
        raise ValueError(f"origin must be (3,) float32, got "
                         f"{tuple(origin.shape)} {origin.dtype}")
    if min(res_h, res_w, th, tw) < 1:
        raise ValueError(f"bad image {res_h}x{res_w} or tile {th}x{tw}")
    if dev.type == "cpu":
        return bin_tri_pass_reference(proj, origin, p1, e1, e2, res_h, res_w,
                                      th, tw, eps, backface_cull)
    if dev.type != "cuda":
        raise ValueError(f"no bin_tri_pass kernel for {dev}")
    pt = _proj_tensors(proj, dev)
    origin = origin.contiguous()
    nb = -(-t_n // _lib().bin_prepass_threads()) if t_n else 1
    i32, i64, f32 = torch.int32, torch.int64, torch.float32
    out = TriPass(ntiles=torch.empty((t_n,), dtype=i64, device=dev),
                  tinfo=torch.empty((t_n, 3), dtype=i32, device=dev),
                  ftab=torch.empty((t_n, GEOM_ROWS), dtype=f32, device=dev),
                  stats=torch.empty((8,), dtype=f32, device=dev),
                  cross_tris=torch.empty((), dtype=i64, device=dev))
    part = torch.empty((nb, 8), dtype=f32, device=dev)
    part_c = torch.empty((nb,), dtype=i64, device=dev)
    counter = torch.zeros((1,), dtype=i32, device=dev)
    k1, eps_f = _mt_scalars(eps)
    _raise("bin_tri_pass", _lib().bin_tri_pass_launch(
        t_n, _ptrs(leaves), _ptrs(pt), origin.data_ptr(), res_h, res_w, th,
        tw, int(bool(backface_cull)), k1, eps_f, out.ntiles.data_ptr(),
        out.tinfo.data_ptr(), out.ftab.data_ptr(), part.data_ptr(),
        part_c.data_ptr(), counter.data_ptr(), out.stats.data_ptr(),
        out.cross_tris.data_ptr(), _stream(dev)))
    bin_tri_pass.launches += 1
    return out


bin_tri_pass.launches = 0


def bin_tri_pass_reference(proj, origin, p1, e1, e2, res_h, res_w, th, tw,
                           eps, backface_cull) -> TriPass:
    """Plain PyTorch version of `bin_tri_pass` (steps 1-2 and the MT
    constants of the plain ``bin_triangles``, and the root box of
    ``bin_object``)."""
    i32, i64 = torch.int32, torch.int64
    p1x, p1y, p1z = p1
    e1x, e1y, e1z = e1
    e2x, e2y, e2z = e2

    q0x, q0y, q0z = (p1x - proj.origin[0], p1y - proj.origin[1],
                     p1z - proj.origin[2])

    def _dotb(vx, vy, vz, b):
        return vx * b[0] + vy * b[1] + vz * b[2]

    a0 = _dotb(q0x, q0y, q0z, proj.n)
    b0 = _dotb(q0x, q0y, q0z, proj.u)
    c0 = _dotb(q0x, q0y, q0z, proj.v)
    a1 = a0 + _dotb(e1x, e1y, e1z, proj.n)
    b1 = b0 + _dotb(e1x, e1y, e1z, proj.u)
    c1 = c0 + _dotb(e1x, e1y, e1z, proj.v)
    a2 = a0 + _dotb(e2x, e2y, e2z, proj.n)
    b2 = b0 + _dotb(e2x, e2y, e2z, proj.u)
    c2 = c0 + _dotb(e2x, e2y, e2z, proj.v)

    f0, f1, f2 = a0 > 0.0, a1 > 0.0, a2 > 0.0
    all_front = f0 & f1 & f2
    any_front = f0 | f1 | f2
    cross = any_front & ~all_front

    if backface_cull:
        # One shared origin: "facing away" is a per-triangle plane test,
        # (e1 x e2) . (p1 - o) > 0. On a closed, consistently wound surface
        # seen from outside such a hit is always behind a nearer front face.
        nx = e1y * e2z - e1z * e2y
        ny = e1z * e2x - e1x * e2z
        nz = e1x * e2y - e1y * e2x
        away = (nx * (p1x - origin[0]) + ny * (p1y - origin[1])
                + nz * (p1z - origin[2])) > 0.0
        cross = cross & ~away
        any_front = any_front & ~away

    def _px(b, a):
        return proj.adjust_x + proj.sx * (b / torch.clamp_min(a, 1e-20))

    def _py(c, a):
        return proj.adjust_y + proj.sy * (c / torch.clamp_min(a, 1e-20))

    px0, px1, px2 = _px(b0, a0), _px(b1, a1), _px(b2, a2)
    py0, py1, py2 = _py(c0, a0), _py(c1, a1), _py(c2, a2)
    guard = 0.5
    x0 = torch.minimum(torch.minimum(px0, px1), px2) - guard
    x1 = torch.maximum(torch.maximum(px0, px1), px2) + guard
    y0 = torch.minimum(torch.minimum(py0, py1), py2) - guard
    y1 = torch.maximum(torch.maximum(py0, py1), py2) + guard
    # camera-plane crossers: conservative full-screen bbox
    x0 = torch.where(cross, 0.0, x0)
    y0 = torch.where(cross, 0.0, y0)
    x1 = torch.where(cross, float(res_w - 1), x1)
    y1 = torch.where(cross, float(res_h - 1), y1)

    # clamp in float before every float -> int cast: out-of-range casts are
    # undefined in C++ and saturate in XLA
    ix0 = torch.clamp(torch.ceil(x0), 0, res_w - 1).to(i64)
    ix1 = torch.floor(torch.clamp(x1, 0, res_w - 1)).to(i64)
    iy0 = torch.clamp(torch.ceil(y0), 0, res_h - 1).to(i64)
    iy1 = torch.floor(torch.clamp(y1, 0, res_h - 1)).to(i64)
    onscreen = (any_front & (x1 >= 0) & (x0 <= res_w - 1)
                & (y1 >= 0) & (y0 <= res_h - 1)
                & (ix1 >= ix0) & (iy1 >= iy0))

    tx0 = ix0 // tw
    ty0 = iy0 // th
    ntx = torch.where(onscreen, ix1 // tw - tx0 + 1, 0)
    nty = torch.where(onscreen, iy1 // th - ty0 + 1, 0)

    depth = torch.minimum(
        torch.minimum(torch.where(f0, a0, BIG), torch.where(f1, a1, BIG)),
        torch.where(f2, a2, BIG))
    depth = torch.clamp_min(depth, 0.0)
    # camera-plane crossers can be hit nearer than their nearest front
    # vertex, so their depth certificate must be 0 (else the kernel's gate
    # could skip the block that holds the true nearest hit)
    depth = torch.where(cross, 0.0, depth)
    d_lo = _amin(torch.where(onscreen, depth, BIG))
    d_hi = _amax(torch.where(onscreen & torch.isfinite(depth), depth, 0.0))

    # Primary rays share the object-frame origin o, so per (entry, ray d):
    # det = A.d, u' = B.d, v' = C.d with A = k1 (e2 x e1),
    # B = e2 x tv - eps A/k1, C = tv x e1 - eps A/k1, TD = k1 e2.(tv x e1),
    # tv = o - p1, k1 = 1 - eps (the reference's per-camera cache,
    # Trixel.cu:29-36, with the acceptance epsilons folded in).
    ox, oy, oz = origin[0], origin[1], origin[2]
    tvx, tvy, tvz = ox - p1x, oy - p1y, oz - p1z
    mdx = e2y * e1z - e2z * e1y                            # e2 x e1
    mdy = e2z * e1x - e2x * e1z
    mdz = e2x * e1y - e2y * e1x
    mux = e2y * tvz - e2z * tvy                            # e2 x tv
    muy = e2z * tvx - e2x * tvz
    muz = e2x * tvy - e2y * tvx
    mvx = tvy * e1z - tvz * e1y                            # tv x e1
    mvy = tvz * e1x - tvx * e1z
    mvz = tvx * e1y - tvy * e1x
    td = e2x * mvx + e2y * mvy + e2z * mvz
    k1, eps_f = _mt_scalars(eps)
    ftab = torch.stack(
        [k1 * mdx, k1 * mdy, k1 * mdz,
         mux - eps_f * mdx, muy - eps_f * mdy, muz - eps_f * mdz,
         mvx - eps_f * mdx, mvy - eps_f * mdy, mvz - eps_f * mdz,
         k1 * td, depth], dim=1)                           # (T, 11)

    # the root box: the three vertices' minimum and maximum
    bmin, bmax = [], []
    for v1, d1, d2 in ((p1x, e1x, e2x), (p1y, e1y, e2y), (p1z, e1z, e2z)):
        v2, v3 = v1 + d1, v1 + d2
        bmin.append(_amin(torch.minimum(torch.minimum(v1, v2), v3)))
        bmax.append(_amax(torch.maximum(torch.maximum(v1, v2), v3)))
    return TriPass(ntiles=ntx * nty,
                   tinfo=torch.stack([ntx, tx0, ty0], dim=1).to(i32),
                   ftab=ftab, stats=torch.stack([*bmin, *bmax, d_lo, d_hi]),
                   cross_tris=cross.sum())


# ---- K8's second launch: the ray table ----

def ray_table(proj, o: torch.Tensor, bounds: torch.Tensor, n_tiles: int,
              n_tx: int, th: int, tw: int, draw_distance: float
              ) -> torch.Tensor:
    """(n_tiles, th*tw, 4) f32 [dx | dy | dz | scene-exit bound] of the
    frame's (or band's: ``proj.row0``) tiles in row-major order, bounded by
    the root box ``bounds`` (6,) = (min xyz, max xyz); the plain version is
    ``accel/traverse.py`` `_ray_table`."""
    dev = o.device
    if o.shape != (3,) or o.dtype != torch.float32 \
            or bounds.shape[0] < 6 or bounds.dtype != torch.float32 \
            or bounds.device != dev:
        raise ValueError(f"o (3,) and bounds (6,) must be float32 on {dev}")
    if min(n_tiles, n_tx, th, tw) < 1:
        raise ValueError(f"bad tiling: {n_tiles} tiles, {n_tx} across, "
                         f"{th}x{tw}")
    if dev.type == "cpu":
        from ...accel.traverse import _ray_table
        return _ray_table(proj, o, bounds[:3], bounds[3:6], n_tiles, n_tx,
                          th, tw, draw_distance)
    if dev.type != "cuda":
        raise ValueError(f"no ray_table kernel for {dev}")
    pt = _proj_tensors(proj, dev)
    o, bounds = o.contiguous(), bounds.contiguous()
    p = th * tw
    rays = torch.empty((n_tiles, p, 4), dtype=torch.float32, device=dev)
    _raise("ray_table", _lib().ray_table_launch(
        n_tiles, p, n_tx, th, tw, int(proj.row0), _ptrs(pt), o.data_ptr(),
        bounds.data_ptr(), float(draw_distance), rays.data_ptr(),
        _stream(dev)))
    ray_table.launches += 1
    return rays


ray_table.launches = 0


# ---- K9a: the entry keys ----

def _check_tri_pass(tp: TriPass, dev):
    t_n = tp.ntiles.shape[0]
    for name, shape, dtype in (("ntiles", (t_n,), torch.int64),
                               ("tinfo", (t_n, 3), torch.int32),
                               ("ftab", (t_n, GEOM_ROWS), torch.float32),
                               ("stats", (8,), torch.float32)):
        x = getattr(tp, name)
        if x.shape != shape or x.dtype != dtype or x.device != dev \
                or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous {shape} {dtype} on "
                             f"{dev}, got {tuple(x.shape)} {x.dtype} on "
                             f"{x.device}")


def bin_entry_keys(cum: torch.Tensor, tp: TriPass, n_tiles: int, n_tx: int,
                   size: int, dbits: int):
    """(key (size,) i32, tri (size,) i32, qstep () f32): entry j's (tile,
    depth bucket) key and triangle, for the entries of `bin_tri_pass`'s
    triangles in order (``cum``, (T,) i64, the inclusive cumsum of
    ``tp.ntiles``); slots past the live count are dead (triangle T, the key
    (n_tiles << dbits) | dmax); a live count above ``size`` is cut."""
    dev = cum.device
    t_n = tp.ntiles.shape[0]
    if cum.shape != (t_n,) or cum.dtype != torch.int64 \
            or not cum.is_contiguous():
        raise ValueError(f"cum must be contiguous ({t_n},) int64")
    _check_tri_pass(tp, dev)
    if size < 0 or not 1 <= dbits <= 30 or n_tiles < 1 \
            or (n_tiles << dbits) >= 1 << 31:
        raise ValueError(f"bad size {size}, dbits {dbits} or {n_tiles} tiles")
    if dev.type == "cpu":
        return bin_entry_keys_reference(cum, tp, n_tiles, n_tx, size, dbits)
    if dev.type != "cuda":
        raise ValueError(f"no bin_entry_keys kernel for {dev}")
    key = torch.empty((size,), dtype=torch.int32, device=dev)
    tri = torch.empty((size,), dtype=torch.int32, device=dev)
    qstep = torch.empty((), dtype=torch.float32, device=dev)
    _raise("bin_entry_keys", _lib().entry_keys_launch(
        t_n, cum.data_ptr(), tp.ntiles.data_ptr(), tp.tinfo.data_ptr(),
        tp.ftab.data_ptr(), tp.stats.data_ptr(), n_tx, n_tiles, dbits, size,
        key.data_ptr(), tri.data_ptr(), qstep.data_ptr(), _stream(dev)))
    bin_entry_keys.launches += 1
    return key, tri, qstep


bin_entry_keys.launches = 0


def bin_entry_keys_reference(cum, tp: TriPass, n_tiles, n_tx, size, dbits):
    """Plain PyTorch version of `bin_entry_keys` (step 3 of the plain
    ``bin_triangles``: the expansion and the key)."""
    dev = cum.device
    i32, i64 = torch.int32, torch.int64
    t_n = cum.shape[0]
    dmax = (1 << dbits) - 1
    d_lo, d_hi = tp.stats[6], tp.stats[7]
    d_rng = torch.clamp_min(d_hi - d_lo, 1e-20)
    dmax_f = torch.full_like(d_rng, float(dmax))   # filled on the device
    scale = dmax_f / d_rng
    # f32(dmax) may round up to 2**dbits, so clamp again in int space; an
    # overflowing depth bucket would spill into the tile bits of the key
    dq = torch.clamp(torch.clamp_min((tp.ftab[:, 10] - d_lo) * scale, 0.0),
                     max=float(dmax)).to(i64).clamp_(max=dmax)
    ntx, tx0, ty0 = tp.tinfo.to(i64).unbind(1)
    j = torch.arange(size, dtype=i64, device=dev)
    # entry j -> triangle #{t : cum[t] <= j}; a dead entry (j >= the live
    # count) finds triangle T, the dead row appended to the table
    tri_j = torch.searchsorted(cum, j, right=True)
    itab = torch.stack([cum, tp.ntiles, ntx, tx0, ty0, dq], dim=1)
    itab = torch.cat([itab, itab.new_zeros((1, 6))])      # the dead row
    ient = itab.index_select(0, tri_j)                     # (E, 6)
    si = j - ient[:, 0] + ient[:, 1]
    ntx_j = torch.clamp_min(ient[:, 2], 1)
    tile_j = (ient[:, 4] + si // ntx_j) * n_tx + ient[:, 3] + si % ntx_j
    key = ((tile_j << dbits) | ient[:, 5]).to(i32)
    # dead entries: tile n_tiles at depth dmax, a key above every live one
    # that still fits in 31 bits
    key = torch.where(tri_j < t_n, key, (n_tiles << dbits) | dmax)
    return key, tri_j.to(i32), d_rng / dmax_f


# ---- K9b: the entry table ----

def bin_entry_table(key: torch.Tensor, order: torch.Tensor,
                    tri: torch.Tensor, ftab: torch.Tensor, n_tiles: int,
                    dbits: int, e_pad: int):
    """(geom (11, e_pad) f32, entry_tri (e_pad,) i32, starts (n_tiles + 1,)
    i32) from the sorted keys ``key`` (size,), the sort's ``order`` (size,)
    i64, `bin_entry_keys`'s ``tri`` (size,) i32 in slot order and
    `bin_tri_pass`'s ``ftab`` (T, 11): each entry's MT column (zeros and
    depth BIG when dead), its id (-1 when dead), the dead columns past
    ``size`` and each tile's first entry (lower_bound of its key)."""
    dev = key.device
    size = key.shape[0]
    for name, x, dtype in (("key", key, torch.int32),
                           ("order", order, torch.int64),
                           ("tri", tri, torch.int32)):
        if x.shape != (size,) or x.dtype != dtype or x.device != dev \
                or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous ({size},) {dtype} "
                             f"on {dev}, got {tuple(x.shape)} {x.dtype}")
    if ftab.dim() != 2 or ftab.shape[1] != GEOM_ROWS \
            or ftab.dtype != torch.float32 or ftab.device != dev \
            or not ftab.is_contiguous():
        raise ValueError(f"ftab must be contiguous (T, {GEOM_ROWS}) float32")
    if e_pad <= size or not 1 <= dbits <= 30 or n_tiles < 1:
        raise ValueError(f"e_pad {e_pad} must exceed {size} entries; "
                         f"dbits {dbits}, {n_tiles} tiles")
    if dev.type == "cpu":
        return bin_entry_table_reference(key, order, tri, ftab, n_tiles,
                                         dbits, e_pad)
    if dev.type != "cuda":
        raise ValueError(f"no bin_entry_table kernel for {dev}")
    geom = torch.empty((GEOM_ROWS, e_pad), dtype=torch.float32, device=dev)
    entry_tri = torch.empty((e_pad,), dtype=torch.int32, device=dev)
    starts = torch.empty((n_tiles + 1,), dtype=torch.int32, device=dev)
    _raise("bin_entry_table", _lib().entry_table_launch(
        size, e_pad, ftab.shape[0], n_tiles, dbits, key.data_ptr(),
        order.data_ptr(), tri.data_ptr(), ftab.data_ptr(), geom.data_ptr(),
        entry_tri.data_ptr(), starts.data_ptr(), _stream(dev)))
    bin_entry_table.launches += 1
    return geom, entry_tri, starts


bin_entry_table.launches = 0


def bin_entry_table_reference(key, order, tri, ftab, n_tiles, dbits, e_pad):
    """Plain PyTorch version of `bin_entry_table` (steps 4-5 of the plain
    ``bin_triangles`` after the sort)."""
    dev = key.device
    i32, i64 = torch.int32, torch.int64
    size, t_n = key.shape[0], ftab.shape[0]
    tri_sorted = tri.to(i64).index_select(0, order)

    # ---- per-tile segment starts: lower_bound(keys, tile << dbits) ----
    # (n_tiles << dbits < 2**31, so the last query counts every entry)
    tile_keys = torch.arange(n_tiles + 1, dtype=i64, device=dev) << dbits
    starts = torch.searchsorted(key, tile_keys.to(i32)).to(i32)

    # ---- per-triangle MT constants, gathered in entry order ----
    dead = torch.zeros((e_pad - size, GEOM_ROWS), dtype=torch.float32,
                       device=dev)
    dead[:, 10] = BIG
    # dead entries gather the dead row T: zero constants, depth BIG
    ftab = torch.cat([ftab, dead[:1]])
    ids = torch.where(tri_sorted < t_n, tri_sorted, -1).to(i32)
    geom = torch.cat([ftab.index_select(0, tri_sorted), dead]).T.contiguous()
    entry_tri = torch.cat([ids, torch.full((e_pad - size,), -1, dtype=i32,
                                           device=dev)])
    return geom, entry_tri, starts
