"""The one dispatch from an intersect method (its facts: ``utils/config.py``
`METHODS`) to its intersect and its accel. Every intersect takes one
object's `ObjectFrame` (``models/camera.py``), triangles and accel, the
config and the band's height and width, and returns the object's hits.
"""

from __future__ import annotations

from ..ops.intersect import FixedOriginCache, Hit, mt_brute, mt_fixed_origin
from ..utils.config import METHODS
from .binning import active_bin_budget
from .native import build_kd_fast
from .raster import intersect_raster
from .traverse import (ClusterAccel, KDTables, intersect_binned,
                       intersect_clustered, intersect_clustered_pallas,
                       intersect_clustered_pallas_v2, kd_intersect)


def _bin(frame, tris, accel, config, band_h, band_w) -> Hit:
    """Inside `bin_budget` the table has the budget's capacity and its live
    count is recorded in the budget."""
    budget = active_bin_budget()
    out = intersect_binned(frame.origin, frame.rays, tris, frame.proj,
                           config, band_h, band_w, capacity=None
                           if budget is None else budget.capacity)
    if budget is None:
        return out
    budget.record(out[1])
    return out[0]


INTERSECTS = {
    "brute": lambda f, tris, accel, c, bh, bw: mt_brute(
        f.origin, f.rays, tris, c.draw_distance, c.eps, c.chunk),
    "fixed": lambda f, tris, accel, c, bh, bw: mt_fixed_origin(
        f.rays, FixedOriginCache.build(f.origin, tris), c.draw_distance,
        c.eps, c.chunk),
    "bin": _bin,
    "grid": lambda f, tris, accel, c, bh, bw: intersect_clustered(
        f.origin, f.rays, tris, accel, c, bh, bw),
    "pallas": lambda f, tris, accel, c, bh, bw: intersect_clustered_pallas(
        f.origin, f.rays, accel, c, bh, bw),
    "pallas2": lambda f, tris, accel, c, bh, bw:
        intersect_clustered_pallas_v2(f.origin, f.rays, accel, c, bh, bw),
    "kd": lambda f, tris, accel, c, bh, bw: kd_intersect(
        f.origin, f.rays, accel, c.draw_distance, c.eps, width=bw or 0),
    "raster": lambda f, tris, accel, c, bh, bw: intersect_raster(
        f.origin, f.rays, tris, f.proj, c, bh, bw),
}


def _kd_tables(tris, leaf_size: int) -> KDTables:
    lo, hi = (x.detach().cpu().numpy() for x in tris.aabbs())
    return KDTables.from_tree(build_kd_fast(lo, hi, leaf_size), tris)


_BUILDERS = {"ClusterAccel": ClusterAccel.build, "KDTables": _kd_tables}


def build_accel(method: str, tris, leaf_size: int) -> tuple | None:
    """The renderer's ``accel`` for ``method`` over objects with the
    triangles ``tris`` (one `Triangles` an object, those shared sharing one
    accel, of leaves of up to ``leaf_size``), or None for a method without
    one."""
    kind = METHODS[method].accel
    if kind is None:
        return None
    built = {}
    for t in tris:
        if id(t) not in built:
            built[id(t)] = _BUILDERS[kind](t, leaf_size)
    return tuple(built[id(t)] for t in tris)
