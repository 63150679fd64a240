"""The one dispatch from an intersect method (its facts: ``utils/config.py``
`METHODS`) to its intersect and its accel. Every intersect takes one
object's `ObjectFrame` (``models/camera.py``), triangles and accel, the
config and the band's height and width, and returns the object's hits.
"""

from __future__ import annotations

from ..ops.intersect import FixedOriginCache, Hit, mt_brute, mt_fixed_origin
from ..utils.config import METHODS
from ..utils.graphs import active_budget
from .native import build_kd_fast
from .raster import intersect_raster
from .traverse import (ClusterAccel, KDTables, intersect_binned,
                       intersect_clustered, intersect_clustered_pallas,
                       intersect_clustered_pallas_v2, kd_intersect)


def _sized(intersect):
    """``intersect(frame, tris, accel, config, band_h, band_w, size)``
    inside `utils/graphs.py` `sized`: at its budget's capacity, the live
    count recorded in the budget; else at None."""
    def run(frame, tris, accel, config, band_h, band_w) -> Hit:
        budget = active_budget()
        out = intersect(frame, tris, accel, config, band_h, band_w,
                        None if budget is None else budget.capacity)
        if budget is None:
            return out
        budget.record(out[1])
        return out[0]
    return run


INTERSECTS = {
    "brute": lambda f, tris, accel, c, bh, bw: mt_brute(
        f.origin, f.rays, tris, c.draw_distance, c.eps, c.chunk),
    "fixed": lambda f, tris, accel, c, bh, bw: mt_fixed_origin(
        f.rays, FixedOriginCache.build(f.origin, tris), c.draw_distance,
        c.eps, c.chunk),
    "bin": _sized(lambda f, tris, accel, c, bh, bw, cap: intersect_binned(
        f.origin, f.rays, tris, f.proj, c, bh, bw, capacity=cap)),
    "grid": lambda f, tris, accel, c, bh, bw: intersect_clustered(
        f.origin, f.rays, tris, accel, c, bh, bw),
    "pallas": lambda f, tris, accel, c, bh, bw: intersect_clustered_pallas(
        f.origin, f.rays, accel, c, bh, bw),
    "pallas2": _sized(lambda f, tris, accel, c, bh, bw, cap:
                      intersect_clustered_pallas_v2(f.origin, f.rays, accel,
                                                    c, bh, bw, bucket=cap)),
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
