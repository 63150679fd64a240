"""Bin-intersect: the nearest hit per primary ray over a tile's
depth-sorted entry blocks (kernel K1 of the JAX package,
``ops/pallas/bin_kernel3.py``), with the telemetry switch of kernel K3
(``ops/pallas/bin_kernel2.py``): ``esub`` gated slices per block and
per-tile scan counts.

- `bin_intersect` is the wrapper. For CUDA tensors it launches the
  hand-written kernels in ``csrc/bin_intersect.cu`` and raises if a launch
  fails; for CPU tensors it runs `bin_intersect_reference`. Nothing falls
  back from the card to the plain version.
- Two walks. At ``esub`` 1 without ``with_steps`` (every frame and training
  step) K1 scans only each tile's own entries of its blocks (ROADMAP F9);
  the telemetry switch (K3) keeps the JAX kernels' walk over whole blocks,
  on which its counts are defined.
- `bin_intersect_reference` is the plain PyTorch version with the same
  contract. It processes round k, the k-th block of every tile, at once
  (in tile groups to bound memory) and applies the same gate per round and
  slice, so it scans the same entries as the kernels and agrees with them
  bit for bit. `walk_work` counts the entries either walk scans and the
  pairs it accepts, for their bounds.
- `bin_intersect.launches` counts kernel launches, and
  `bin_intersect.telemetry_launches` those of them with the telemetry
  switch (K3: ``esub`` above 1 or ``with_steps``).

The kernels are built by `._build` (nvcc at first use, ctypes).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...utils.dtypes import DEFAULT_DRAW_DISTANCE, MT_EPSILON
from . import _build

GEOM_ROWS = 11            # entry-table rows: A(3) | B(3) | C(3) | TD | depth
_MISS_T = 3.0e38
_NO_TRI = torch.iinfo(torch.int32).max
_PAIRS = 1 << 24          # ray-entry pairs per group of the plain version
_THREADS = 512            # the largest CTA of either walk (kThreads)
_lib = []


def _launchers():
    """(K1's launch, K3's launch) from the built library."""
    if not _lib:
        lib = _build.load("bin_intersect")
        own = lib.bin_intersect_own_launch
        own.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                        + [ctypes.c_float] * 3 + [ctypes.c_void_p])
        aligned = lib.bin_intersect_launch
        aligned.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                            + [ctypes.c_float] * 3 + [ctypes.c_void_p])
        own.restype = aligned.restype = ctypes.c_int
        _lib.append((own, aligned))
    return _lib[0]


def walk_shape(p: int, rays: int | None = None,
               groups: int | None = None) -> tuple[int, int]:
    """The CTA of the walks (K1, K3 and K6) for P rays a tile: (rays a
    thread, groups). Each group of P / rays threads holds all of the tile's
    rays; the groups split each block's (slice's, chunk's) entries, up to
    `_THREADS` threads. By default 4 rays a thread where P allows; a given
    ``rays`` or ``groups`` is kept and the other fills the CTA."""
    rays = rays or next(r for r in (4, 2, 1) if p % (32 * r) == 0)
    return rays, groups or max(1, _THREADS // (p // rays))


def effective_esub(chunk: int, esub: int) -> int:
    """The slice count the JAX kernel really uses: it halves ``esub`` until
    it divides ``chunk`` into slices of a multiple of 128 entries
    (bin_kernel2.py:174-175), so at chunk 128 every esub means 1."""
    if esub < 1:
        raise ValueError(f"esub {esub} must be >= 1")
    while esub > 1 and (chunk % esub or (chunk // esub) % 128):
        esub //= 2
    return esub


def _constants(eps: float, draw_distance: float):
    """eps, (k1·eps)² and the draw distance rounded to float32, as the JAX
    kernel's weakly typed Python constants are (bin_kernel3.py:61-62)."""
    k1 = 1.0 - eps
    return (float(np.float32(eps)), float(np.float32((k1 * eps) ** 2)),
            float(np.float32(draw_distance)))


def _check(rays, geom, entry_tri, starts, chunk):
    if chunk <= 0 or chunk & (chunk - 1):
        raise ValueError(f"chunk {chunk} must be a power of two")
    if rays.dim() != 3 or rays.shape[2] != 4 or rays.dtype != torch.float32:
        raise ValueError(f"rays must be (nT, P, 4) float32, got "
                         f"{tuple(rays.shape)} {rays.dtype}")
    n_t = rays.shape[0]
    if (geom.dim() != 2 or geom.shape[0] != GEOM_ROWS
            or geom.dtype != torch.float32 or geom.shape[1] % chunk
            or geom.shape[1] < chunk):
        raise ValueError(f"geom must be ({GEOM_ROWS}, k*{chunk}) float32, "
                         f"got {tuple(geom.shape)} {geom.dtype}")
    if entry_tri.shape != (geom.shape[1],) or entry_tri.dtype != torch.int32:
        raise ValueError("entry_tri must be (Epad,) int32")
    if starts.shape != (n_t + 1,) or starts.dtype != torch.int32:
        raise ValueError("starts must be (nT + 1,) int32")
    for name, x in (("rays", rays), ("geom", geom), ("entry_tri", entry_tri),
                    ("starts", starts)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != rays.device:
            raise ValueError(f"{name} is on {x.device}, rays on {rays.device}")


def bin_intersect(rays: torch.Tensor, geom: torch.Tensor,
                  entry_tri: torch.Tensor, starts: torch.Tensor,
                  chunk: int = 512, eps: float = MT_EPSILON,
                  draw_distance: float = DEFAULT_DRAW_DISTANCE,
                  esub: int = 1, with_steps: bool = False,
                  longest_first: bool = True):
    """Nearest hit per ray over binned entries.

    rays: (nT, P, 4) f32 [dx, dy, dz, scene-exit bound] per tile;
    geom: (11, Epad) f32 rows A(3) | B(3) | C(3) | TD | depth in entry order;
    entry_tri: (Epad,) i32 triangle ids; starts: (nT + 1,) i32 entry range
    per tile. Every block a tile reaches, starts[t] // chunk through
    (starts[t+1] - 1) // chunk, must lie inside the table (bin_triangles
    pads it with a dead chunk). Returns (t (nT, P) f32, draw distance on a
    miss; tri (nT, P) i32, -1 on a miss), and with ``with_steps`` also
    steps (nT, 2) i32 = [slices scanned, blocks walked] per tile. ``esub``
    splits each block into gated slices (`effective_esub`). At esub 1
    without steps only the tile's own entries of each block, [starts[t],
    starts[t+1]), take part, in the gate and the select (K1); otherwise
    every entry of the blocks does (K3, the JAX kernels' walk). Both walks
    take the tiles longest first; ``longest_first=False`` takes them in
    index order, with the same result (chip_smoke.py times the two).
    """
    _check(rays, geom, entry_tri, starts, chunk)
    esub = effective_esub(chunk, esub)
    if rays.device.type == "cpu":
        return bin_intersect_reference(rays, geom, entry_tri, starts, chunk,
                                       eps, draw_distance, esub, with_steps)
    telemetry = esub > 1 or with_steps
    out = _launch(rays, geom, entry_tri, starts, chunk, eps, draw_distance,
                  esub, with_steps, longest_first=longest_first)
    bin_intersect.launches += 1
    bin_intersect.telemetry_launches += int(telemetry)
    return out


def _launch(rays, geom, entry_tri, starts, chunk, eps, draw_distance, esub,
            with_steps, *, rays_per_thread=None, groups=None, overlap=True,
            longest_first=True):
    """Launch K1 (``esub`` 1 without steps) or K3 on CUDA tensors.
    ``rays_per_thread`` and ``groups`` (default: `walk_shape`), ``overlap``
    (K3: copy the next block under the current one's scan) and
    ``longest_first`` exist to measure each design lever against its
    absence; `bin_intersect` sets only the last."""
    if rays.device.type != "cuda":
        raise ValueError(f"no bin_intersect kernel for {rays.device}")
    n_t, p, _ = rays.shape
    if p % 32 or not 32 <= p <= 1024:
        raise ValueError(f"P = {p} rays per tile must be a multiple of 32 "
                         "in [32, 1024]")
    telemetry = esub > 1 or with_steps
    r_thread, groups = walk_shape(p, rays_per_thread, groups)
    smem = (2 * (GEOM_ROWS + 1) * chunk * 4 + groups * p * 8
            + (2 * -(-chunk // 32) * 4 + p * 8 if telemetry else 0))
    if smem > 227 * 1024:
        raise ValueError(f"chunk {chunk} does not fit in shared memory")
    if rays.data_ptr() % 16:
        raise ValueError("rays must be 16-byte aligned (read as float4)")
    out_t = torch.empty((n_t, p), dtype=torch.float32, device=rays.device)
    out_tri = torch.empty((n_t, p), dtype=torch.int32, device=rays.device)
    steps = (torch.empty((n_t, 2), dtype=torch.int32, device=rays.device)
             if with_steps else None)
    out = (out_t, out_tri, steps) if with_steps else (out_t, out_tri)
    if n_t == 0:
        return out
    eps_f, eps2_det, draw = _constants(eps, draw_distance)
    stream = torch.cuda.current_stream(rays.device).cuda_stream
    order = (torch.empty(n_t, dtype=torch.int32, device=rays.device)
             if longest_first else None)
    ptrs = (rays.data_ptr(), geom.data_ptr(), entry_tri.data_ptr(),
            starts.data_ptr(), None if order is None else order.data_ptr(),
            out_t.data_ptr(), out_tri.data_ptr())
    own, aligned = _launchers()
    if telemetry:
        err = aligned(*ptrs, None if steps is None else steps.data_ptr(),
                      n_t, p, geom.shape[1], chunk, esub, r_thread, groups,
                      int(overlap), eps_f, eps2_det, draw, stream)
    else:
        err = own(*ptrs, n_t, p, geom.shape[1], chunk, r_thread, groups,
                  eps_f, eps2_det, draw, stream)
    if err != 0:
        raise RuntimeError(f"bin_intersect kernel launch failed: CUDA error "
                           f"{err}")
    return out


bin_intersect.launches = 0
bin_intersect.telemetry_launches = 0


def bin_intersect_reference(rays: torch.Tensor, geom: torch.Tensor,
                            entry_tri: torch.Tensor, starts: torch.Tensor,
                            chunk: int = 512, eps: float = MT_EPSILON,
                            draw_distance: float = DEFAULT_DRAW_DISTANCE,
                            esub: int = 1, with_steps: bool = False):
    """Plain PyTorch version of `bin_intersect` (same contract, same
    result bit for bit)."""
    esub = effective_esub(chunk, esub)
    own = esub == 1 and not with_steps
    t, tri, scanned, nblk, _ = _walk(rays, geom, entry_tri, starts, chunk,
                                     eps, draw_distance, esub, own)
    if not with_steps:
        return t, tri
    return t, tri, torch.stack([scanned, nblk], dim=1).to(torch.int32)


def walk_work(rays: torch.Tensor, geom: torch.Tensor,
              entry_tri: torch.Tensor, starts: torch.Tensor,
              chunk: int = 512, eps: float = MT_EPSILON,
              draw_distance: float = DEFAULT_DRAW_DISTANCE, esub: int = 1,
              own: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """A walk's work per tile, two (nT,) int64: the entries of the blocks
    (``own``: K1, the tile's own entries) or of the ``esub`` slices (K3)
    whose gate opened, each scanned against all P rays of its tile, and the
    ray-entry pairs among those that the test accepted."""
    esub = effective_esub(chunk, esub)
    _, _, scanned, _, accepted = _walk(rays, geom, entry_tri, starts, chunk,
                                       eps, draw_distance, esub, own)
    return (scanned if own else scanned * (chunk // esub)), accepted


def _walk(rays, geom, entry_tri, starts, chunk, eps, draw_distance, esub,
          own):
    """The walk of both kernels: over whole blocks in ``esub`` slices, or
    (``own``) over each block's own entries of the tile. Returns t, tri and
    three (nT,) int64 per tile: slices scanned (``own``: entries scanned),
    blocks walked, and ray-entry pairs accepted."""
    el = chunk // esub
    eps_f, eps2_det, draw = _constants(eps, draw_distance)
    n_t, p, _ = rays.shape
    dev = rays.device
    s0, s1 = starts[:-1].long(), starts[1:].long()
    first = s0 // chunk
    nblk = torch.where(s1 > s0, (s1 - 1) // chunk - first + 1, 1)
    g = geom.view(GEOM_ROWS, -1, chunk)            # (11, blocks, chunk)
    ids = entry_tri.view(-1, chunk)
    dmin = g[10].view(-1, esub, el).amin(dim=2)    # per-slice min depth
    bound = rays[..., 3]
    best_t = torch.full((n_t, p), draw, dtype=torch.float32, device=dev)
    best_tri = torch.full((n_t, p), -1, dtype=torch.int32, device=dev)
    scanned = torch.zeros(n_t, dtype=torch.int64, device=dev)
    accepted = torch.zeros(n_t, dtype=torch.int64, device=dev)
    group = max(1, _PAIRS // (p * el))
    rounds = int(nblk.max()) if n_t else 0
    col = torch.arange(chunk, device=dev)
    for k in range(rounds):
        tiles_k = torch.nonzero(nblk > k).squeeze(1)
        blk_k = first[tiles_k] + k
        if own:                                    # the tile's own entries
            pos = blk_k[:, None] * chunk + col
            mine_k = (pos >= s0[tiles_k, None]) & (pos < s1[tiles_k, None])
            dmin_k = torch.where(mine_k, g[10][blk_k], torch.inf).amin(dim=1)
        for sl in range(esub):
            wb = torch.minimum(best_t[tiles_k], bound[tiles_k]).amax(dim=1)
            go = (dmin_k if own else dmin[blk_k, sl]) < wb   # the gate
            tiles, blk = tiles_k[go], blk_k[go]
            scanned[tiles] += mine_k[go].sum(dim=1) if own else 1
            cols = slice(sl * el, (sl + 1) * el)
            for i in range(0, tiles.shape[0], group):
                tg, bg = tiles[i:i + group], blk[i:i + group]
                gg = g[:, bg, None, cols]          # (11, n, 1, el)
                r = rays[tg]
                dx, dy, dz = r[..., 0:1], r[..., 1:2], r[..., 2:3]  # (n, P, 1)
                det = dx * gg[0] + dy * gg[1] + dz * gg[2]          # (n, P, el)
                up = dx * gg[3] + dy * gg[4] + dz * gg[5]
                vp = dx * gg[6] + dy * gg[7] + dz * gg[8]
                td = gg[9]
                dd2 = det * det
                qq = torch.minimum(up * det, vp * det)
                qq = torch.minimum(qq, (det - up - vp) * det)
                qq = torch.minimum(qq, td * det - eps_f * dd2)
                ok = (qq >= 0.0) & (dd2 >= eps2_det)
                tt = torch.where(ok, td / torch.where(det == 0.0, 1e-30, det),
                                 _MISS_T)
                if own:                            # other tiles' entries out
                    mine = mine_k[go][i:i + group, None]
                    tt = torch.where(mine, tt, torch.inf)
                    ok = ok & mine
                accepted[tg] += ok.sum(dim=(1, 2))
                tmin = tt.amin(dim=2)
                tri = torch.where(tt == tmin[..., None],
                                  ids[bg][:, None, cols], _NO_TRI).amin(dim=2)
                cur_t, cur_tri = best_t[tg], best_tri[tg]
                better = tmin < cur_t
                best_t[tg] = torch.where(better, tmin, cur_t)
                best_tri[tg] = torch.where(better, tri, cur_tri)
    return best_t, best_tri, scanned, nblk, accepted
