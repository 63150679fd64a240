"""Render configuration: the JAX package's ``RenderConfig``, field for field.

The fields and their defaults are the same, so a configuration translates
one to one. What the port does not run yet raises ``NotImplementedError``
at construction, naming the ROADMAP item that brings it. Fields that only
the unported cluster paths read are accepted and unused until then.
"""

from __future__ import annotations

import dataclasses

from .dtypes import DEFAULT_BACKGROUND_RGB, DEFAULT_DRAW_DISTANCE, MT_EPSILON

_PORTED_METHODS = ("brute", "fixed", "bin")
_LATER_METHODS = {
    "grid": "ROADMAP queue 1 item 10 (cluster path)",
    "pallas": "ROADMAP queue 1 item 10 (cluster path, kernel K5)",
    "pallas2": "ROADMAP queue 1 item 10 (cluster path, kernel K4)",
    "kd": "ROADMAP queue 1 item 10 (KD path)",
    "raster": "ROADMAP queue 1 item 10 (scatter-min raster path)",
}


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    # Ray termination distance (Camera.cpp:70 / Trixel.cu:47 hardcode 400).
    draw_distance: float = DEFAULT_DRAW_DISTANCE
    # Miss-pixel fill colour (Camera.cpp:72).
    background_rgb: tuple[int, int, int] = DEFAULT_BACKGROUND_RGB
    # MT acceptance epsilon (vector.cuh:10-13).
    eps: float = MT_EPSILON
    # Intersection backend: "brute" (oracle), "fixed" (matmul-form brute)
    # or "bin" (screen-space binning + the bin-intersect kernel).
    method: str = "fixed"
    # Triangle chunk for the brute paths (bounds rays x chunk memory).
    chunk: int = 2048
    # --- cluster paths (grid / pallas / pallas2), not ported yet ---
    leaf_size: int = 128
    # Ray-tile edge lengths in pixels; the bin path bins triangles to them.
    tile_h: int = 16
    tile_w: int = 32
    max_candidates: int = 48
    group_size: int = 32
    max_groups: int = 0
    sub_h: int = 0
    sub_w: int = 0
    escalate_tiles: int = 64
    escalate_factor: int = 4
    # Per-tile scan telemetry (kernel K3): intersect_binned then returns
    # (Hit, stats); trace_rays refuses it, as in the JAX package.
    with_stats: bool = False
    debug_mode: int = 0
    mt_precision: str = "highest"
    # --- screen-space binning path (method="bin", accel/binning.py) ---
    # Entries per block of the depth-sorted entry table; the kernel scans
    # a tile's entries block by block (a power of two).
    bin_chunk: int = 512
    # Unused: the port sizes the entry table from the live entry count, so
    # no geometry is ever dropped (ROADMAP F3). Kept so configs translate.
    bin_e_factor: float = 1.2
    # Only "float32": the bf16 preview of kernel K1 is not ported.
    bin_mt_dtype: str = "float32"
    # Gated entry slices per block (kernel K3); read only under
    # with_stats, as in the JAX package (its gen-6 path ignores it, F5).
    bin_esub: int = 1
    # Unused: there is no capacity to escalate (see bin_e_factor).
    bin_escalate: bool = True
    # Cull triangles facing away from the shared primary-ray origin before
    # binning. Exact for closed, consistently wound surfaces seen from
    # outside; off by default because the reference's MT is two-sided.
    backface_cull: bool = False
    # --- raster path, not ported yet ---
    raster_span: int = 4
    raster_ovf_cap: int = 512
    # Shading-gather backward: True sorts the ids and sums segments with
    # kernel K2 (ops/gather.py); False leaves index_select's own
    # scatter-add backward, as the JAX package then uses jnp.take.
    sorted_scatter: bool = True

    def __post_init__(self):
        if self.method in _LATER_METHODS:
            raise NotImplementedError(
                f"method={self.method!r} is not ported yet: "
                f"{_LATER_METHODS[self.method]}")
        if self.method not in _PORTED_METHODS:
            raise ValueError(f"unknown intersect method {self.method!r}")
        if self.bin_mt_dtype != "float32":
            raise NotImplementedError(
                "bin_mt_dtype='bfloat16' (the approximate preview of "
                "kernel K1) is not ported")
