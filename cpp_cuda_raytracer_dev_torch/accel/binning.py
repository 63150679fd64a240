"""Screen-space tile binning for primary rays (the JAX package's
``accel/binning.py``).

All primary rays leave one origin, so a pixel's ray can only hit a
triangle whose projection covers the pixel. Per object and frame:

1. project the three vertices through `Projection` into subpixel
   coordinates (a = depth along the view axis);
2. pixel bbox (+0.5 px guard) -> tile range; triangles that cross the
   camera plane bin to every tile; triangles fully behind or off screen
   drop; optionally triangles facing away from the origin drop;
3. expand triangle -> (tile, triangle) entries: entry j belongs to
   triangle searchsorted_right(cumsum(tiles per triangle), j);
4. one stable 32-bit key sort by (tile, quantised min depth): each tile's
   entries come out contiguous and front to back;
5. gather the per-triangle MT constants into an (11, Epad) table in entry
   order, with the triangle ids beside it as int32.

By default the entry table is sized from the live entry count (one host
sync per frame), so no entry is ever dropped (ROADMAP F3). With a
``capacity`` (a bucket, `render_jit` and the compiled training step) every
per-entry tensor has that static size and the live count stays on the
device: the entries past it are dead, and the caller reads the count after
the frame and runs it again at a larger bucket if it did not fit (ROADMAP
F13). Entries with equal keys keep triangle order, as ``jax.lax.sort``
does, so the entry order, and with it every tie outcome of the kernel, is
the JAX package's.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses

import torch

from ..ops.cuda.bin_intersect import GEOM_ROWS
from ..utils.dtypes import MT_EPSILON

BIG = 3.0e38


@dataclasses.dataclass
class BinnedScene:
    """Per-frame, per-object binning output."""

    geom: torch.Tensor        # (11, Epad) f32 MT-constant table, entry order
    entry_tri: torch.Tensor   # (Epad,) i32 triangle id per entry, -1 = dead
    starts: torch.Tensor      # (nT + 1,) i32 entry range per tile
    qstep: torch.Tensor       # scalar f32 depth-quantisation bucket width
    # live entries E (Epad = E rounded up + chunk); with a capacity a
    # scalar i64 on the device (Epad = capacity + chunk)
    num_entries: int | torch.Tensor
    cross_tris: torch.Tensor  # scalar i64 camera-plane-crossing triangles


@dataclasses.dataclass
class BinBudget:
    """The entry capacity of every bin table built inside `bin_budget`, and
    the largest live count among them (a scalar i64 on the device, None
    until a table is built)."""

    capacity: int
    live: torch.Tensor | None = None

    def record(self, n_e: torch.Tensor) -> None:
        self.live = n_e if self.live is None else torch.maximum(self.live,
                                                                n_e)


_BUDGET: contextvars.ContextVar = contextvars.ContextVar("bin_budget",
                                                         default=None)


@contextlib.contextmanager
def bin_budget(capacity: int | None):
    """Inside, the renderer's bin tables have ``capacity`` entries and
    record their live counts in the yielded `BinBudget`; ``None`` yields
    None and changes nothing."""
    if capacity is None:
        yield None
        return
    budget = BinBudget(capacity)
    token = _BUDGET.set(budget)
    try:
        yield budget
    finally:
        _BUDGET.reset(token)


def active_bin_budget() -> BinBudget | None:
    return _BUDGET.get()


def bin_triangles(proj, origin: torch.Tensor, p1, e1, e2,
                  res_h: int, res_w: int, th: int, tw: int,
                  chunk: int = 512, eps: float = MT_EPSILON,
                  backface_cull: bool = False,
                  capacity: int | None = None) -> BinnedScene:
    """Bin object-frame triangles to (th x tw) pixel tiles.

    ``proj`` is the Projection in the object frame, ``origin`` the
    object-frame ray origin, and p1, e1, e2 are (x, y, z) tuples of flat
    (T,) tensors (the Triangles leaves). The table's tail holds at least
    one dead chunk (det = 0, depth BIG), so that reading any tile's last
    block whole never runs past the end.

    ``capacity`` (a multiple of ``chunk``): the table holds that many
    entries, then the dead chunk, and nothing is read back. Entries past the
    live count are dead (triangle -1, zero constants, depth BIG) and sort
    after every live one, so the live entries, their order and ``starts``
    are bitwise the live-count table's. A live count above the capacity
    truncates the table: the caller must read ``num_entries`` and redo the
    frame at a larger capacity.
    """
    dev = origin.device
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    p1x, p1y, p1z = p1
    e1x, e1y, e1z = e1
    e2x, e2y, e2z = e2
    t_n = p1x.shape[0]
    n_tx = -(-res_w // tw)
    n_ty = -(-res_h // th)
    n_tiles = n_tx * n_ty

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
    ntiles_tri = ntx * nty

    # ---- expansion: entry j -> triangle #{t : cum[t] <= j} ----
    cum = torch.cumsum(ntiles_tri, dim=0)                  # inclusive, i64
    if capacity is None:
        # the live count sizes every per-entry tensor: the frame's one sync
        n_e = int(cum[-1]) if t_n else 0
        size = n_e
    else:
        if capacity <= 0 or capacity % chunk:
            raise ValueError(f"capacity {capacity} must be a positive "
                             f"multiple of chunk {chunk}")
        n_e = cum[-1] if t_n else torch.zeros((), dtype=i64, device=dev)
        size = capacity
    j = torch.arange(size, dtype=i64, device=dev)
    # a dead entry (j >= n_e) finds triangle T, the dead row appended to
    # each per-triangle table below
    tri_j = torch.searchsorted(cum, j, right=True)

    # ---- (tile, quantised depth) key ----
    dbits = 31 - n_tiles.bit_length()
    if dbits < 6:
        raise ValueError(f"{n_tiles} tiles leaves only {dbits} depth bits; "
                         "use larger tiles")
    dmax = (1 << dbits) - 1
    depth = torch.minimum(
        torch.minimum(torch.where(f0, a0, BIG), torch.where(f1, a1, BIG)),
        torch.where(f2, a2, BIG))
    depth = torch.clamp_min(depth, 0.0)
    # camera-plane crossers can be hit nearer than their nearest front
    # vertex, so their depth certificate must be 0 (else the kernel's gate
    # could skip the block that holds the true nearest hit)
    depth = torch.where(cross, 0.0, depth)
    d_lo = torch.where(onscreen, depth, BIG).amin()
    d_hi = torch.where(onscreen & torch.isfinite(depth), depth, 0.0).amax()
    d_rng = torch.clamp_min(d_hi - d_lo, 1e-20)
    dmax_f = torch.full_like(d_rng, float(dmax))   # filled on the device
    scale = dmax_f / d_rng
    # f32(dmax) may round up to 2**dbits, so clamp again in int space; an
    # overflowing depth bucket would spill into the tile bits of the key
    dq = torch.clamp(torch.clamp_min((depth - d_lo) * scale, 0.0),
                     max=float(dmax)).to(i64).clamp_(max=dmax)

    itab = torch.stack([cum, ntiles_tri, ntx, tx0, ty0, dq], dim=1)
    if capacity is not None:
        itab = torch.cat([itab, itab.new_zeros((1, 6))])   # the dead row
    ient = itab.index_select(0, tri_j)                     # (E, 6)
    si = j - ient[:, 0] + ient[:, 1]
    ntx_j = torch.clamp_min(ient[:, 2], 1)
    tile_j = (ient[:, 4] + si // ntx_j) * n_tx + ient[:, 3] + si % ntx_j
    key = ((tile_j << dbits) | ient[:, 5]).to(i32)
    if capacity is not None:
        # dead entries: tile n_tiles at depth dmax, a key above every live
        # one that still fits in 31 bits
        key = torch.where(tri_j < t_n, key, (n_tiles << dbits) | dmax)
    key, order = torch.sort(key, stable=True)
    tri_sorted = tri_j.index_select(0, order)

    # ---- per-tile segment starts: lower_bound(keys, tile << dbits) ----
    # (n_tiles << dbits < 2**31, so the last query counts every entry)
    tile_keys = torch.arange(n_tiles + 1, dtype=i64, device=dev) << dbits
    starts = torch.searchsorted(key, tile_keys.to(i32)).to(i32)

    # ---- per-triangle MT constants, gathered in entry order ----
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
    k1 = float(torch.tensor(1.0 - eps, dtype=f32))
    eps_f = float(torch.tensor(eps, dtype=f32))
    ftab = torch.stack(
        [k1 * mdx, k1 * mdy, k1 * mdz,
         mux - eps_f * mdx, muy - eps_f * mdy, muz - eps_f * mdz,
         mvx - eps_f * mdx, mvy - eps_f * mdy, mvz - eps_f * mdz,
         k1 * td, depth], dim=1)                           # (T, 11)

    e_pad = -(-size // chunk) * chunk + chunk
    dead = torch.zeros((e_pad - size, GEOM_ROWS), dtype=f32, device=dev)
    dead[:, 10] = BIG
    ids = tri_sorted.to(i32)
    if capacity is not None:
        # dead entries gather the dead row T: zero constants, depth BIG
        ftab = torch.cat([ftab, dead[:1]])
        ids = torch.where(tri_sorted < t_n, ids, -1)
    geom = torch.cat([ftab.index_select(0, tri_sorted), dead]).T.contiguous()
    entry_tri = torch.cat([ids, torch.full((e_pad - size,), -1, dtype=i32,
                                           device=dev)])
    return BinnedScene(geom=geom, entry_tri=entry_tri, starts=starts,
                       qstep=d_rng / dmax_f, num_entries=n_e,
                       cross_tris=cross.sum())
