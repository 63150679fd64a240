"""Cross-rank combines for sharded rendering (the JAX package's
``parallel/collectives.py``).

When triangles are range-sharded over the "prims" axis, every rank finds
the nearest hit within its own range; the global nearest hit is a
min-reduce over shards keyed by distance, carrying the (tri, obj) payload:
the distributed form of `Hit.merge` and of the reference's per-thread
nearest-hit select (Trixel.cu:127-142) across the primitive axis.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.intersect import Hit

_I32_MAX = torch.iinfo(torch.int32).max


def _all_min(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, op=dist.ReduceOp.MIN, group=group)
    return x


def allreduce_nearest_hit(hit: Hit, group) -> Hit:
    """Global nearest hit across the ranks of ``group`` (a process group,
    for example ``mesh.get_group("prims")``).

    Three staged minima in the hit's float dtype and int32: the distances,
    then among the ranks that reach the minimum the triangle id (an exact
    tie across shards goes to the lowest id, as the single-device chunk
    scan of `mt_fixed_origin` / `Hit.merge` has it), then the object id of
    that winner. A ray that every shard misses stays -1. Every rank of the
    group gets the same result.
    """
    tmin = _all_min(hit.t, group)
    mine = (hit.t <= tmin) & (hit.tri >= 0)
    tri_win = _all_min(torch.where(mine, hit.tri, _I32_MAX), group)
    winner = mine & (hit.tri == tri_win)
    obj_win = _all_min(torch.where(winner, hit.obj, _I32_MAX), group)
    miss = tri_win == _I32_MAX
    return Hit(t=tmin, tri=torch.where(miss, -1, tri_win).to(torch.int32),
               obj=torch.where(miss, -1, obj_win).to(torch.int32))
