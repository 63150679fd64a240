"""The renderer: ray generation -> per-object intersect -> nearest combine ->
shade -> compose (the JAX package's ``models/renderer.py``).

Hit selection (triangle ids) is discrete and runs without gradients; the
shading path re-derives the hit distance from the selected triangle's
geometry, so autograd reaches vertices, poses, camera and Phong parameters
at fixed topology.

`render_differentiable` is the frame with autograd (the loss calls it);
`render` is the same body under ``torch.inference_mode``, for serving;
`render_jit` is `render` captured into a CUDA graph and replayed
(utils/graphs.py), the port's counterpart of the JAX package's
``render_jit``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..accel.binning import BinBudget
from ..accel.methods import INTERSECTS
from ..accel.traverse import EscalateBudget, bin_object, escalation_need
from ..ops.intersect import Hit
from ..utils import graphs
from ..utils.config import METHODS, RenderConfig
from ..utils.profiling import span
from .camera import Camera, object_frames, set_up_frame
from .scene import Scene
from .shade_grad import shade_compose_grad
from .shading import shade_compose


@dataclasses.dataclass
class RenderOutput:
    """Frame outputs; row 0 of every image is the bottom. Float outputs
    have the scene's dtype (float32 unless it was built in float64)."""

    image: torch.Tensor      # (H, W, 3) uint8
    radiance: torch.Tensor   # (H, W, 3) pre-tonemap, 0 on miss
    hit_t: torch.Tensor      # (H, W)
    hit_tri: torch.Tensor    # (H, W) int32, -1 = miss
    hit_obj: torch.Tensor    # (H, W) int32, -1 = miss
    normal: torch.Tensor     # (H, W, 3) world space (0 on miss)
    point: torch.Tensor      # (H, W, 3) world-space hit points


@torch.no_grad()
def trace_rays(scene: Scene, origin: torch.Tensor, rmd: torch.Tensor,
               config: RenderConfig, accel=None, band_h: int | None = None,
               band_w: int | None = None, proj=None, frames=None) -> Hit:
    """Nearest hit over all objects for unit rays ``rmd`` (R, 3) from
    ``origin``; band_h * band_w == R (row-major) for the tiled paths.
    ``accel``: one an object where `METHODS` names one (`ClusterAccel`
    for "grid", "pallas", "pallas2", `KDTables` for "kd"); the methods that
    read the camera Projection need ``proj`` (world frame); the
    float32-only methods refuse float64 rays.

    Each object moves the rays into its own frame (pose-on-the-ray,
    Trixel.cu:60-66); geometry never moves, so an accel built once serves
    every pose. ``frames``: the objects' `ObjectFrame`s of these rays (a
    `FrameSetup`'s), else `object_frames` derives them.
    """
    if config.with_stats:
        raise ValueError("with_stats makes the intersect paths return "
                         "(Hit, stats); call intersect_clustered_pallas_v2 "
                         "/ intersect_binned directly for telemetry")
    facts = METHODS[config.method]
    if facts.accel and accel is None:
        raise ValueError(f"method={config.method!r} needs accel, one "
                         f"{facts.accel} per object")
    if facts.float32 and rmd.dtype != torch.float32:
        raise TypeError(f"method={config.method!r} runs in float32 only, "
                        f"not {rmd.dtype}; use 'brute' or 'fixed' for "
                        "float64")
    if facts.proj and proj is None:
        raise ValueError(f"method={config.method!r} needs the camera "
                         "Projection (render() provides it)")
    if frames is None:
        frames = object_frames([obj.pose for obj in scene.objects], origin,
                               rmd, proj, config.method)
    best = Hit.miss(rmd.shape[0], config.draw_distance, device=rmd.device,
                    dtype=rmd.dtype)
    for oi, (obj, frame) in enumerate(zip(scene.objects, frames)):
        hit = INTERSECTS[config.method](
            frame, obj.tris, None if accel is None else accel[oi], config,
            band_h, band_w)
        hit.obj = torch.where(hit.tri >= 0, oi, -1).to(torch.int32)
        best = best.merge(hit)
    return best


def render_rays(scene: Scene, origin: torch.Tensor, rmd: torch.Tensor,
                config: RenderConfig, accel=None, band_h: int | None = None,
                band_w: int | None = None, proj=None, frames=None) -> dict:
    """Flat-ray pipeline (trace + shade + compose); a dict of flat per-ray
    tensors. The trace runs without gradients (hit topology is discrete)."""
    hit = trace_rays(scene, origin, rmd, config, accel, band_h, band_w, proj,
                     frames)
    return shade_and_compose(scene, origin, rmd, hit, config)


def shade_and_compose(scene: Scene, origin: torch.Tensor, rmd: torch.Tensor,
                      hit: Hit, config: RenderConfig) -> dict:
    """Shade the hits and compose the image: `render_rays`'s dict of flat
    per-ray tensors for a given hit (the sharded paths combine hits across
    ranks first). With autograd on and an input that requires grad (the
    training steps) `shade_compose_grad`, differentiable: kernel K10
    forward and kernel K12 backward on CUDA tensors, their plain twins on
    CPU tensors; else (`render`, `render_jit`, the sharded serving paths)
    ``models/shading.py`` `shade_compose`, kernel K10 on CUDA tensors and
    the plain version on CPU tensors. Every route's outputs are
    `shade_compose_reference`'s, bit for bit."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (rmd, origin, hit.t,
                                      *scene.parameters())):
        return shade_compose_grad(scene, origin, rmd, hit, config)
    return shade_compose(scene, origin, rmd, hit, config)


def render_differentiable(scene: Scene, camera: Camera,
                          config: RenderConfig = RenderConfig(), accel=None
                          ) -> RenderOutput:
    """One frame on the scene's device, differentiable with respect to the
    scene's and the camera's parameters (the JAX package's ``render``).
    ``accel``: one `ClusterAccel` per object for the cluster methods, one
    `KDTables` per object for "kd". The set-up (rays, Projection, the
    objects' frames) is `set_up_frame`'s: kernel K11 on the card, whose
    rays carry the camera's gradient through kernel K13 where a camera leaf
    needs autograd."""
    setup = set_up_frame(camera, [obj.pose for obj in scene.objects],
                        config.method)
    flat = render_rays(scene, camera.pos, setup.rmd, config, accel,
                       camera.res_h, camera.res_w, proj=setup.proj,
                       frames=setup.objects)
    h, w = camera.res_h, camera.res_w
    return RenderOutput(**{k: v.reshape(h, w, *v.shape[1:])
                           for k, v in flat.items()})


@torch.inference_mode()
def render(scene: Scene, camera: Camera,
           config: RenderConfig = RenderConfig(), accel=None
           ) -> RenderOutput:
    """One forward frame on the scene's device: the serving entry point,
    run under ``torch.inference_mode``."""
    return render_differentiable(scene, camera, config, accel)


def jit_captures(config: RenderConfig) -> bool:
    """Whether `render_jit`, `render_sharded_jit` and `make_train_step_jit`
    capture ``config.method`` on CUDA (`METHODS`)."""
    return METHODS[config.method].captured


def bin_entry_count(scene: Scene, camera: Camera, config: RenderConfig,
                    row0: int = 0, band_h: int | None = None) -> int:
    """The largest live entry count of the frame's bin tables: the probe
    that picks a key's first bucket (one uncaptured prepass an object).
    ``row0`` and ``band_h``: a band's first row and height (the sharded
    paths), else the whole frame. It reads no rays, so none are made."""
    with torch.no_grad():
        setup = set_up_frame(camera, [obj.pose for obj in scene.objects],
                             "bin", row0, band_h, rays=False)
        return max(bin_object(frame.origin, obj.tris, frame.proj, config,
                              band_h or camera.res_h - row0,
                              camera.res_w)[1].num_entries
                   for obj, frame in zip(scene.objects, setup.objects))


def escalation_count(scene: Scene, camera: Camera, config: RenderConfig,
                     accel, row0: int = 0, band_h: int | None = None
                     ) -> torch.Tensor:
    """The live counts that size "pallas2"'s exact escalation
    (`accel/traverse.py` `escalation_need`), the elementwise largest over
    the objects: the probe of a key's first bucket (one uncaptured cull an
    object, K4 not run), of a band as `bin_entry_count`'s."""
    with torch.no_grad():
        setup = set_up_frame(camera, [obj.pose for obj in scene.objects],
                             config.method, row0, band_h)
        need = [escalation_need(frame.origin, frame.rays, a, config,
                                band_h or camera.res_h - row0, camera.res_w)
                for a, frame in zip(accel, setup.objects)]
        return torch.stack(need).amax(dim=0)


def _bin_probe(scene: Scene, camera: Camera, config: RenderConfig, accel,
               row0: int = 0, band_h: int | None = None) -> int:
    return bin_entry_count(scene, camera, config, row0, band_h)


def _bucketing(config: RenderConfig):
    """What a frame or step of ``config`` sizes at a bucket of a live count
    (`utils/graphs.py` `GraphCache`), as (its `Budget` class, its probe
    (scene, camera, config, accel, row0, band_h), its least bucket): the
    bin tables' entries (a ``probed`` method), or the tiles "pallas2"
    escalates and their candidates (under ``escalate_all``); None where
    it has no bucket."""
    facts = METHODS[config.method]
    if facts.probed:
        return BinBudget, _bin_probe, config.bin_chunk
    if facts.escalates and config.escalate_all:
        return EscalateBudget, escalation_count, (1, 1)
    return None


def budget(config: RenderConfig, bucket) -> graphs.Budget | None:
    """The `Budget` that sizes a frame or step of ``config`` at ``bucket``
    (for `utils/graphs.py` `sized`), None where it has no bucket."""
    sizing = _bucketing(config)
    return None if sizing is None else sizing[0](bucket)


def bucket_probe(scene: Scene, camera: Camera, config: RenderConfig, accel,
                 row0: int = 0, band_h: int | None = None):
    """(probe, least bucket) of ``config`` for `GraphCache.run`: the probe
    of the frame's (or a band's) live count that picks a key's first
    bucket; (None, None) where it has no bucket."""
    sizing = _bucketing(config)
    if sizing is None:
        return None, None
    _, probe, least = sizing
    return (lambda _: probe(scene, camera, config, accel, row0, band_h),
            least)


def compiled_frame(cache: graphs.GraphCache, frame, scene: Scene,
                   camera: Camera, config: RenderConfig, accel, *mesh,
                   band=(0, None)):
    """``frame(scene, camera, config, *mesh, accel)`` without gradients
    through ``cache`` (`utils/graphs.py`: captured on CUDA, what `budget`
    sizes at a bucket that grows with the live count), keyed
    by the config, the leaves' shapes, dtypes and device, the resolution
    and the ``accel`` objects; the first bucket comes from `bucket_probe`
    of the rows ``band`` = (row0, band_h). The outputs are bitwise the
    frame's."""
    key = (config, graphs.signature((scene, camera)), camera.res_h,
           camera.res_w, None if accel is None else tuple(id(a)
                                                          for a in accel))

    def body(args, bucket):
        with torch.no_grad(), graphs.sized(budget(config, bucket)) as b:
            out = frame(*args, config, *mesh, accel)
        return out, b

    probe, least = bucket_probe(scene, camera, config, accel, *band)
    return cache.run(key, (scene, camera), body, probe, least, pin=accel)


# render_jit's graphs, one memory pool (utils/graphs.py `GraphCache`)
FRAME_GRAPHS = graphs.GraphCache()


def render_jit(scene: Scene, camera: Camera,
               config: RenderConfig = RenderConfig(), accel=None
               ) -> RenderOutput:
    """`render` compiled (`compiled_frame`; "kd" replays its traversal
    kernel K7 inside the graph). A method that `jit_captures` does not
    capture ("raster", a dense list sized from the live count) runs as
    `render` does.

    `FRAME_GRAPHS` is the `GraphCache` (captures, buckets, regrowths). The
    call runs in the span ``rt.render_jit`` (`utils/profiling.py`).
    """
    with span("rt.render_jit"):
        if not jit_captures(config):
            return render(scene, camera, config, accel)
        return compiled_frame(FRAME_GRAPHS, render_differentiable, scene,
                              camera, config, accel)
