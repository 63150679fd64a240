"""Render configuration: the JAX package's ``RenderConfig``, field for field.

The fields and their defaults are the same, so a configuration translates
one to one. The TPU-only modes (the bf16 pass counts of the TPU's matrix
unit, the bf16 preview of kernel K1 and K4's floor probes) raise
``NotImplementedError`` at construction: a deliberate difference (ROADMAP
F10, decided in queue 1's former item 8).
"""

from __future__ import annotations

import dataclasses

from .dtypes import DEFAULT_BACKGROUND_RGB, DEFAULT_DRAW_DISTANCE, MT_EPSILON

_METHODS = ("brute", "fixed", "bin", "grid", "pallas", "pallas2", "kd",
            "raster")
_TPU_ONLY = "a TPU-only mode, ROADMAP F10"


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    # Ray termination distance (Camera.cpp:70 / Trixel.cu:47 hardcode 400).
    draw_distance: float = DEFAULT_DRAW_DISTANCE
    # Miss-pixel fill colour (Camera.cpp:72).
    background_rgb: tuple[int, int, int] = DEFAULT_BACKGROUND_RGB
    # MT acceptance epsilon (vector.cuh:10-13).
    eps: float = MT_EPSILON
    # Intersection backend: "brute" (oracle), "fixed" (matmul-form brute),
    # "bin" (screen-space binning + the bin-intersect kernel K1), or a
    # cluster path over a ClusterAccel: "grid" (plain PyTorch), "pallas"
    # (kernel K5) or "pallas2" (kernel K4); "kd", the reference's per-ray
    # stack traversal over `KDTables` (kernel K7 on the card); or
    # "raster", scatter-min rasterization (accel/raster.py, plain PyTorch).
    method: str = "fixed"
    # Triangle chunk for the brute paths (bounds rays x chunk memory).
    chunk: int = 2048
    # --- cluster paths (grid / pallas / pallas2) ---
    # Triangles per KD leaf cluster (ClusterAccel.build).
    leaf_size: int = 128
    # Ray-tile edge lengths in pixels: the cluster paths cull per tile, the
    # bin path bins triangles to them.
    tile_h: int = 16
    tile_w: int = 32
    # Candidate clusters kept per tile, nearest first.
    max_candidates: int = 48
    # Two-level cull: the nearest `max_groups` visible groups of
    # `group_size` consecutive clusters are tested cluster by cluster;
    # 0 = flat cull.
    group_size: int = 32
    max_groups: int = 0
    # pallas2 sub-tiles: rays ordered so each (sub_h, sub_w) sub-tile is a
    # contiguous run; they change ray order and telemetry, never a hit.
    sub_h: int = 0
    sub_w: int = 0
    # pallas2 overflow escalation: the `escalate_tiles` tiles with the
    # most overflow are culled again, flat, at max_candidates *
    # escalate_factor and their hits spliced in. 0 = off.
    escalate_tiles: int = 64
    escalate_factor: int = 4
    # Telemetry: intersect_binned (kernel K3) and
    # intersect_clustered_pallas_v2 then return (Hit, stats); trace_rays
    # refuses it, as in the JAX package.
    with_stats: bool = False
    # pallas2 kernel debug: 1 counts sub-tile MT executions (stats
    # "mt_subs"); the TPU floor probes 2 and 3 are not ported.
    debug_mode: int = 0
    # Only "highest" (exact float32): "default" and "high" are bf16 pass
    # counts of the TPU's matrix unit, not ported.
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
    # --- raster path (method="raster", accel/raster.py) ---
    # Pixel span per triangle side enumerated by the scatter pass; wider
    # triangles go to the dense pass.
    raster_span: int = 4
    # Unused: the port sizes the dense pass from the live count, so nothing
    # is dropped (as bin_e_factor). Kept so configs translate.
    raster_ovf_cap: int = 512
    # Shading-gather backward: True sorts the ids and sums segments with
    # kernel K2 (ops/gather.py); False leaves index_select's own
    # scatter-add backward, as the JAX package then uses jnp.take.
    sorted_scatter: bool = True

    def __post_init__(self):
        if self.method not in _METHODS:
            raise ValueError(f"unknown intersect method {self.method!r}")
        if self.mt_precision != "highest":
            raise NotImplementedError(
                f"mt_precision={self.mt_precision!r} (bf16 passes of the "
                f"TPU's matrix unit) is not ported: {_TPU_ONLY}")
        if self.debug_mode in (2, 3):
            raise NotImplementedError(
                f"debug_mode={self.debug_mode} (a TPU floor probe that "
                f"skips the MT) is not ported: {_TPU_ONLY}")
        if self.bin_mt_dtype != "float32":
            raise NotImplementedError(
                "bin_mt_dtype='bfloat16' (the approximate preview of "
                f"kernel K1) is not ported: {_TPU_ONLY}")
