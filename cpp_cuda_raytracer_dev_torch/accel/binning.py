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

import dataclasses

import torch

from ..ops.cuda.bin_prepass import (bin_entry_keys, bin_entry_table,
                                    bin_tri_pass)
from ..utils.dtypes import MT_EPSILON
from ..utils.graphs import Budget


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
    bounds: torch.Tensor      # (6,) f32 the triangles' box, min xyz | max xyz


@dataclasses.dataclass
class BinBudget(Budget):
    """The entry capacity of every bin table built inside `utils/graphs.py`
    `sized`, each table's live entry count (a scalar i64) and their
    largest."""


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

    On CUDA tensors the per-triangle pass and the entry passes are kernels
    K8 and K9 (``ops/cuda/bin_prepass.py``), around ``torch.cumsum`` and
    ``torch.sort``; on CPU tensors their plain versions, bit for bit.
    """
    t_n = p1[0].shape[0]
    n_tx = -(-res_w // tw)
    n_tiles = n_tx * -(-res_h // th)
    dbits = 31 - n_tiles.bit_length()
    if dbits < 6:
        raise ValueError(f"{n_tiles} tiles leaves only {dbits} depth bits; "
                         "use larger tiles")
    tp = bin_tri_pass(proj, origin, p1, e1, e2, res_h, res_w, th, tw, eps,
                      backface_cull)

    # ---- expansion: entry j -> triangle #{t : cum[t] <= j} ----
    cum = torch.cumsum(tp.ntiles, dim=0)                   # inclusive, i64
    if capacity is None:
        # the live count sizes every per-entry tensor: the frame's one sync
        n_e = int(cum[-1]) if t_n else 0
        size = n_e
    else:
        if capacity <= 0 or capacity % chunk:
            raise ValueError(f"capacity {capacity} must be a positive "
                             f"multiple of chunk {chunk}")
        n_e = cum[-1] if t_n else torch.zeros((), dtype=torch.int64,
                                              device=origin.device)
        size = capacity

    # ---- one stable sort by (tile, quantised depth) ----
    key, tri, qstep = bin_entry_keys(cum, tp, n_tiles, n_tx, size, dbits)
    key, order = torch.sort(key, stable=True)
    e_pad = -(-size // chunk) * chunk + chunk
    geom, entry_tri, starts = bin_entry_table(key, order, tri, tp.ftab,
                                              n_tiles, dbits, e_pad)
    return BinnedScene(geom=geom, entry_tri=entry_tri, starts=starts,
                       qstep=qstep, num_entries=n_e,
                       cross_tris=tp.cross_tris, bounds=tp.stats[:6])
