"""Bin-tile-intersect: the nearest hit per primary ray over a tile's whole
chunks of the depth-sorted bin entry table, with the depth-certificate early
exit (kernel K6 of the JAX package, ``ops/pallas/bin_kernel.py``).

- `bin_tile_intersect` is the wrapper, with the contract of the JAX
  package's ``pallas_bin_intersect``. For CUDA tensors it launches the
  hand-written kernel in ``csrc/bin_tile_intersect.cu`` and raises if the
  build or the launch fails; for CPU tensors it runs
  `bin_tile_intersect_reference`. Nothing falls back from the card to the
  plain version.
- `bin_tile_intersect_reference` is the plain PyTorch version with the same
  contract (stated in the CUDA source). It steps the chunk index k for all
  tiles at once (in tile groups to bound memory), with the kernel's per-tile
  exit and gates at each k, and agrees with the kernel bit for bit.
- `tile_operands` builds the kernel's operands from the bin path's ray table
  and `BinnedScene` (``accel/traverse.py`` `bin_object`), and
  `decode_enc` turns its block-relative winners into triangle ids.
- `gated_chunks` counts, per tile, the chunks whose gate opened: the pairs
  the kernel scans are their sum x chunk x P (with ``n_sub`` 1).
- `bin_tile_intersect.launches` counts kernel launches.

Operands: ``d_tiles`` (nT, 3, P) f32 unit directions in the object frame;
``starts`` (nT + 1,) i32 entry range per tile; ``origin10`` (10,) f32 =
origin | root bmin | root bmax | qstep; ``geom`` (Epad / chunk, 10, chunk)
f32, rows p1 | e1 | e2 | depth, dead entries zero with depth 3e38. Outputs:
t (nT, P) f32 (the draw distance on a miss), enc (nT, P) i32 = k * chunk +
slot relative to block starts[t] // chunk (-1 on a miss), steps (nT, 2) i32
= [chunks walked, chunks in range].
"""

from __future__ import annotations

import ctypes

import torch

from ...utils.dtypes import DEFAULT_DRAW_DISTANCE, MT_EPSILON
from . import _build
from .tile_intersect import (_constants, _inv_dirs, _root_bound,
                             _slot_constants)

ROWS = 10                 # p1(3) | e1(3) | e2(3) | depth
_MISS_T = 3.0e38
_PAIRS = 1 << 24          # ray-entry pairs per group of the plain version
_MAX_CHUNK = 1024         # 40 bytes of shared memory an entry
_fn = []


def _launcher():
    if not _fn:
        fn = _build.load("bin_tile_intersect").bin_tile_intersect_launch
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                       + [ctypes.c_float] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn.append(fn)
    return _fn[0]


def _check(d_tiles, starts, origin10, geom, chunk, n_sub, mt_precision,
           debug_mode):
    if mt_precision != "highest":
        raise NotImplementedError(
            f"mt_precision={mt_precision!r} (bf16 passes of the TPU's matrix "
            "unit) is not ported; only 'highest' (exact float32)")
    if chunk <= 0 or chunk & (chunk - 1):
        raise ValueError(f"chunk {chunk} must be a power of two")
    if debug_mode not in (0, 1, 2):
        raise ValueError(f"debug_mode {debug_mode} must be 0, 1 or 2")
    if d_tiles.dim() != 3 or d_tiles.shape[1] != 3 \
            or d_tiles.dtype != torch.float32:
        raise ValueError(f"d_tiles must be (nT, 3, P) float32, got "
                         f"{tuple(d_tiles.shape)} {d_tiles.dtype}")
    n_t, _, p = d_tiles.shape
    if n_sub < 1 or p % n_sub:
        raise ValueError(f"tile ray count {p} not divisible by {n_sub}")
    if starts.shape != (n_t + 1,) or starts.dtype != torch.int32:
        raise ValueError("starts must be (nT + 1,) int32")
    if origin10.shape != (10,) or origin10.dtype != torch.float32:
        raise ValueError("origin10 must be (10,) float32")
    if (geom.dim() != 3 or geom.shape[1:] != (ROWS, chunk)
            or geom.dtype != torch.float32):
        raise ValueError(f"geom must be (Epad / {chunk}, {ROWS}, {chunk}) "
                         f"float32, got {tuple(geom.shape)} {geom.dtype}")
    for name, x in (("d_tiles", d_tiles), ("starts", starts),
                    ("origin10", origin10), ("geom", geom)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != d_tiles.device:
            raise ValueError(f"{name} is on {x.device}, d_tiles on "
                             f"{d_tiles.device}")


def bin_tile_intersect(d_tiles: torch.Tensor, starts: torch.Tensor,
                       origin10: torch.Tensor, geom: torch.Tensor,
                       chunk: int = 128, eps: float = MT_EPSILON,
                       draw_distance: float = DEFAULT_DRAW_DISTANCE,
                       n_sub: int = 1, mt_precision: str = "highest",
                       debug_mode: int = 0):
    """K6: nearest hit per ray over each tile's whole chunks (operands and
    outputs in the module docstring). ``n_sub`` gates runs of P / n_sub
    rays separately; ``debug_mode`` 1 drops the early exit, 2 also every
    gate. Every tile's chunks must lie inside ``geom``."""
    _check(d_tiles, starts, origin10, geom, chunk, n_sub, mt_precision,
           debug_mode)
    if d_tiles.device.type == "cpu":
        return bin_tile_intersect_reference(d_tiles, starts, origin10, geom,
                                            chunk, eps, draw_distance, n_sub,
                                            mt_precision, debug_mode)
    if d_tiles.device.type != "cuda":
        raise ValueError(f"no bin_tile_intersect kernel for {d_tiles.device}")
    n_t, _, p = d_tiles.shape
    if p % 32 or not 32 <= p <= 1024:
        raise ValueError(f"P = {p} rays per tile must be a multiple of 32 "
                         "in [32, 1024] (one thread per ray)")
    sub_len = p // n_sub
    if n_sub > 1 and (32 % sub_len if sub_len < 32 else sub_len % 32):
        raise ValueError(f"sub-tiles of {sub_len} rays must divide 32 or be "
                         "whole warps")
    if chunk > _MAX_CHUNK:
        raise ValueError(f"chunk {chunk} above {_MAX_CHUNK}")
    dev = d_tiles.device
    out_t = torch.empty((n_t, p), dtype=torch.float32, device=dev)
    out_enc = torch.empty((n_t, p), dtype=torch.int32, device=dev)
    steps = torch.empty((n_t, 2), dtype=torch.int32, device=dev)
    if n_t == 0:
        return out_t, out_enc, steps
    eps_f, k1, eps2_det, draw = _constants(eps, draw_distance)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _launcher()(d_tiles.data_ptr(), starts.data_ptr(),
                      origin10.data_ptr(), geom.data_ptr(), out_t.data_ptr(),
                      out_enc.data_ptr(), steps.data_ptr(), n_t, p, chunk,
                      n_sub, debug_mode, eps_f, k1, eps2_det, draw, stream)
    if err != 0:
        raise RuntimeError(f"bin_tile_intersect kernel launch failed: CUDA "
                           f"error {err}")
    bin_tile_intersect.launches += 1
    return out_t, out_enc, steps


bin_tile_intersect.launches = 0


def _walk(d_tiles, starts, origin10, geom, chunk, eps, draw_distance, n_sub,
          debug_mode):
    """The plain version's walk over chunk index k. Returns (t, enc, steps,
    gated chunks per tile)."""
    eps_f, k1, eps2_det, draw = _constants(eps, draw_distance)
    n_t, _, p = d_tiles.shape
    dev = d_tiles.device
    s0, s1 = starts[:-1].long(), starts[1:].long()
    b0 = s0 // chunk
    nch = torch.where(s1 > s0, (s1 - 1) // chunk - b0 + 1, 0)
    qstep = origin10[9]
    bound = _root_bound(origin10[:9], _inv_dirs(d_tiles), draw)
    # every chunk's constants, by the kernel's operations in its order
    cst = _slot_constants(origin10[:3], geom[:, :9], chunk, True, eps_f, k1)
    cmin_all = geom[:, 9].amin(dim=1)                  # (B,)
    d = d_tiles.unbind(1)
    best_t = torch.full((n_t, p), draw, dtype=torch.float32, device=dev)
    enc = torch.full((n_t, p), -1, dtype=torch.int32, device=dev)
    walked = torch.zeros(n_t, dtype=torch.int32, device=dev)
    gated = torch.zeros(n_t, dtype=torch.int32, device=dev)
    wb = bound.amax(dim=1)
    cert = torch.full((n_t,), -3.0e38, dtype=torch.float32, device=dev)
    alive = torch.ones(n_t, dtype=torch.bool, device=dev)
    slot_iota = torch.arange(chunk, dtype=torch.int32, device=dev)
    sp = p // n_sub
    group = max(1, _PAIRS // (sp * chunk))
    for k in range(int(nch.max()) if n_t else 0):
        alive &= k < nch
        if debug_mode < 1:
            alive &= cert < wb
        tiles_k = torch.nonzero(alive).squeeze(1)
        if tiles_k.numel() == 0:
            break
        walked[tiles_k] += 1
        blk_k = b0[tiles_k] + k
        cmin_k = cmin_all[blk_k]
        go = cmin_k < wb[tiles_k]
        if debug_mode >= 2:
            go = torch.ones_like(go)
        tiles, blk, cmin = tiles_k[go], blk_k[go], cmin_k[go]
        gated[tiles] += 1
        for q in range(n_sub):
            cols = slice(q * sp, (q + 1) * sp)
            for i in range(0, tiles.shape[0], group):
                tg, bg, cg = (x[i:i + group] for x in (tiles, blk, cmin))
                cur_t, cur_enc = best_t[tg, cols], enc[tg, cols]
                if n_sub > 1 and debug_mode < 2:
                    sub_go = cg < torch.minimum(cur_t,
                                                bound[tg, cols]).amax(dim=1)
                    tg, bg = tg[sub_go], bg[sub_go]
                    cur_t, cur_enc = cur_t[sub_go], cur_enc[sub_go]
                m = cst[:, bg, None, :]                    # (10, n, 1, chunk)
                dx, dy, dz = (x[tg, cols, None] for x in d)  # (n, sp, 1)
                det = dx * m[0] + dy * m[1] + dz * m[2]    # (n, sp, chunk)
                up = dx * m[3] + dy * m[4] + dz * m[5]
                vp = dx * m[6] + dy * m[7] + dz * m[8]
                td = m[9]
                dd2 = det * det
                qq = torch.minimum(up * det, vp * det)
                qq = torch.minimum(qq, (det - up - vp) * det)
                qq = torch.minimum(qq, td * det - eps_f * dd2)
                ok = (qq >= 0.0) & (dd2 >= eps2_det)
                tt = torch.where(ok, td / det, _MISS_T)
                tmin = tt.amin(dim=2)
                slot = torch.where(tt == tmin[..., None], slot_iota,
                                   chunk).amin(dim=2)
                # only an accepted entry is taken, whatever the draw distance
                better = (tmin < _MISS_T) & (tmin < cur_t)
                best_t[tg, cols] = torch.where(better, tmin, cur_t)
                enc[tg, cols] = torch.where(better, k * chunk + slot, cur_enc)
        wb[tiles_k] = torch.minimum(
            wb[tiles_k],
            torch.minimum(best_t[tiles_k], bound[tiles_k]).amax(dim=1))
        cert[tiles_k] = cmin_k - qstep
    return best_t, enc, torch.stack([walked, nch.to(torch.int32)], 1), gated


def bin_tile_intersect_reference(d_tiles, starts, origin10, geom,
                                 chunk: int = 128, eps: float = MT_EPSILON,
                                 draw_distance: float = DEFAULT_DRAW_DISTANCE,
                                 n_sub: int = 1,
                                 mt_precision: str = "highest",
                                 debug_mode: int = 0):
    """Plain PyTorch version of `bin_tile_intersect` (same contract, same
    result bit for bit)."""
    _check(d_tiles, starts, origin10, geom, chunk, n_sub, mt_precision,
           debug_mode)
    return _walk(d_tiles, starts, origin10, geom, chunk, eps, draw_distance,
                 n_sub, debug_mode)[:3]


def gated_chunks(d_tiles, starts, origin10, geom, chunk: int = 128,
                 eps: float = MT_EPSILON,
                 draw_distance: float = DEFAULT_DRAW_DISTANCE) -> torch.Tensor:
    """(nT,) i32 chunks whose gate opened per tile, at n_sub 1 and
    debug_mode 0 (from the plain version's walk)."""
    _check(d_tiles, starts, origin10, geom, chunk, 1, "highest", 0)
    return _walk(d_tiles, starts, origin10, geom, chunk, eps, draw_distance,
                 1, 0)[3]


@torch.no_grad()
def tile_operands(rays: torch.Tensor, binned, tris, origin: torch.Tensor,
                  chunk: int = 128):
    """K6's operands for one object from the bin path's: ``rays`` (nT, P, 4)
    and ``binned`` (a `BinnedScene`) from `bin_object`, the object's
    `Triangles` and its object-frame ray origin (3,). Returns (d_tiles,
    starts, origin10, geom): the tile directions transposed to (nT, 3, P);
    the tile starts; origin | the root box that `bin_object` bounds rays
    with | qstep; and p1 | e1 | e2 gathered in entry order (zeros for dead
    entries) with the binned depth row, blocked to (Epad / chunk, 10,
    chunk)."""
    e_pad = binned.entry_tri.shape[0]
    if chunk <= 0 or chunk & (chunk - 1) or e_pad % chunk:
        raise ValueError(f"chunk {chunk} must be a power of two dividing the "
                         f"entry table's {e_pad} entries")
    d_tiles = rays[..., :3].transpose(1, 2).contiguous()
    lo, hi = tris.aabbs()
    origin10 = torch.cat([origin, lo.amin(dim=0), hi.amax(dim=0),
                          binned.qstep.reshape(1)]).to(torch.float32)
    live = binned.entry_tri >= 0
    ids = binned.entry_tri.clamp_min(0).long()
    rows = torch.stack([getattr(tris, f)[ids] for f in
                        ("p1x", "p1y", "p1z", "e1x", "e1y", "e1z",
                         "e2x", "e2y", "e2z")])              # (9, Epad)
    rows = torch.cat([torch.where(live, rows, 0.0),
                      binned.geom[10:11]])                   # (10, Epad)
    geom = rows.view(ROWS, -1, chunk).transpose(0, 1).contiguous()
    return d_tiles, binned.starts, origin10.contiguous(), geom


def decode_enc(enc: torch.Tensor, starts: torch.Tensor,
               entry_tri: torch.Tensor, chunk: int = 128) -> torch.Tensor:
    """K6's block-relative winners -> (nT, P) i32 triangle ids, -1 on a
    miss: entry (starts[t] // chunk) * chunk + enc, through ``entry_tri``."""
    first = (starts[:-1].long() // chunk * chunk)[:, None]
    entry = (first + enc.long()).clamp_min(0)
    return torch.where(enc >= 0, entry_tri[entry], -1).to(torch.int32)
