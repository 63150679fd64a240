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

from ..accel.binning import active_bin_budget, bin_budget
from ..ops.cuda.shade import shade_compose
from ..ops.gather import gather_rows, take_rows
from ..ops.intersect import FixedOriginCache, Hit, mt_brute, mt_fixed_origin
from ..ops.shade import compose_framebuffer, phong_radiance_c
from ..utils import graphs
from ..utils.config import RenderConfig
from ..utils.profiling import span
from .camera import PROJ_METHODS, Camera, object_frames, set_up_frame
from .scene import Scene

_ACCEL_METHODS = {"grid": "ClusterAccel", "pallas": "ClusterAccel",
                  "pallas2": "ClusterAccel", "kd": "KDTables"}
# float32 by construction: their kernels' operands (bin, grid, pallas,
# pallas2) or raster's bitcast of t to int32 (as in the JAX package)
_FLOAT32_METHODS = ("bin", "grid", "pallas", "pallas2", "raster")
# render_jit and make_train_step_jit run these uncaptured: raster sizes its
# dense list from the live count (ROADMAP queue 1)
_UNCAPTURED = ("raster",)


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
    ``accel`` is a sequence of `ClusterAccel`, one per object, for the
    cluster methods ("grid", "pallas", "pallas2"), or of `KDTables` for
    "kd"; the bin and raster paths need the camera Projection ``proj``
    (world frame). Only "brute", "fixed" and "kd" take float64 rays.

    Each object moves the rays into its own frame (pose-on-the-ray,
    Trixel.cu:60-66); geometry never moves, so an accel built once serves
    every pose. ``frames``: the objects' `ObjectFrame`s of these rays (a
    `FrameSetup`'s), else `object_frames` derives them.
    """
    if config.with_stats:
        raise ValueError("with_stats makes the intersect paths return "
                         "(Hit, stats); call intersect_clustered_pallas_v2 "
                         "/ intersect_binned directly for telemetry")
    if config.method in _ACCEL_METHODS and accel is None:
        raise ValueError(f"method={config.method!r} needs accel, one "
                         f"{_ACCEL_METHODS[config.method]} per object")
    if config.method in _FLOAT32_METHODS and rmd.dtype != torch.float32:
        raise TypeError(f"method={config.method!r} runs in float32 only, "
                        f"not {rmd.dtype}; use 'brute' or 'fixed' for "
                        "float64")
    if config.method in PROJ_METHODS and proj is None:
        raise ValueError(f"method={config.method!r} needs the camera "
                         "Projection (render() provides it)")
    if frames is None:
        frames = object_frames([obj.pose for obj in scene.objects], origin,
                               rmd, proj, config.method)
    best = Hit.miss(rmd.shape[0], config.draw_distance, device=rmd.device,
                    dtype=rmd.dtype)
    for oi, (obj, frame) in enumerate(zip(scene.objects, frames)):
        d_obj, o_obj = frame.rays, frame.origin
        if config.method == "brute":
            hit = mt_brute(o_obj, d_obj, obj.tris, config.draw_distance,
                           config.eps, config.chunk)
        elif config.method == "fixed":
            cache = FixedOriginCache.build(o_obj, obj.tris)
            hit = mt_fixed_origin(d_obj, cache, config.draw_distance,
                                  config.eps, config.chunk)
        elif config.method == "grid":
            from ..accel.traverse import intersect_clustered
            hit = intersect_clustered(o_obj, d_obj, obj.tris, accel[oi],
                                      config, band_h, band_w)
        elif config.method == "pallas":
            from ..accel.traverse import intersect_clustered_pallas
            hit = intersect_clustered_pallas(o_obj, d_obj, accel[oi],
                                             config, band_h, band_w)
        elif config.method == "pallas2":
            from ..accel.traverse import intersect_clustered_pallas_v2
            hit = intersect_clustered_pallas_v2(o_obj, d_obj, accel[oi],
                                                config, band_h, band_w)
        elif config.method == "kd":
            from ..accel.traverse import kd_intersect
            hit = kd_intersect(o_obj, d_obj, accel[oi], config.draw_distance,
                               config.eps, width=band_w or 0)
        elif config.method == "bin":
            from ..accel.traverse import intersect_binned
            budget = active_bin_budget()
            hit = intersect_binned(o_obj, d_obj, obj.tris, frame.proj,
                                   config, band_h, band_w, capacity=None
                                   if budget is None else budget.capacity)
            if budget is not None:
                hit, live = hit
                budget.record(live)
        elif config.method == "raster":
            from ..accel.raster import intersect_raster
            hit = intersect_raster(o_obj, d_obj, obj.tris, frame.proj,
                                   config, band_h, band_w)
        else:
            raise ValueError(f"unknown intersect method {config.method!r}")
        hit.obj = torch.where(hit.tri >= 0, oi, -1).to(torch.int32)
        best = best.merge(hit)
    return best


def shade_hits(scene: Scene, origin: torch.Tensor, rmd: torch.Tensor,
               hit: Hit, config: RenderConfig):
    """Differentiable shading given the hit indices.

    Returns (radiance (R,3), normal (R,3), point (R,3), hit_mask (R,))."""
    num_r = rmd.shape[0]
    tri_idx = torch.clamp_min(hit.tri, 0)
    # K2 sums float32 rows; a float64 scene keeps index_select's backward
    gather = (gather_rows if config.sorted_scatter
              and rmd.dtype == torch.float32 else take_rows)
    acc = [torch.zeros((num_r,), dtype=rmd.dtype, device=rmd.device)
           for _ in range(9)]
    dx, dy, dz = rmd[:, 0], rmd[:, 1], rmd[:, 2]
    for oi, obj in enumerate(scene.objects):
        mask = (hit.obj == oi) & (hit.tri >= 0)
        t_ = obj.tris
        packed = torch.cat(
            [torch.stack([t_.p1x, t_.p1y, t_.p1z, t_.e1x, t_.e1y, t_.e1z,
                          t_.e2x, t_.e2y, t_.e2z], dim=1), t_.color],
            dim=1)                                           # (T, 12)
        rows, = gather((packed,), tri_idx)
        cr, cg, cb = rows[:, 9], rows[:, 10], rows[:, 11]

        # object-frame ray direction R^T d, componentwise
        m = obj.pose.matrix()
        ox_, oy_, oz_ = obj.pose.inv_apply(origin)
        ddx = m[0, 0] * dx + m[1, 0] * dy + m[2, 0] * dz
        ddy = m[0, 1] * dx + m[1, 1] * dy + m[2, 1] * dz
        ddz = m[0, 2] * dx + m[1, 2] * dy + m[2, 2] * dz

        # Möller–Trumbore t (ops/intersect.py mt_test), acceptance per
        # Trixel.cu:106,127
        e1x, e1y, e1z = rows[:, 3], rows[:, 4], rows[:, 5]
        e2x, e2y, e2z = rows[:, 6], rows[:, 7], rows[:, 8]
        tvx = ox_ - rows[:, 0]
        tvy = oy_ - rows[:, 1]
        tvz = oz_ - rows[:, 2]
        pvx = ddy * e2z - ddz * e2y
        pvy = ddz * e2x - ddx * e2z
        pvz = ddx * e2y - ddy * e2x
        det = e1x * pvx + e1y * pvy + e1z * pvz
        qvx = tvy * e1z - tvz * e1y
        qvy = tvz * e1x - tvx * e1z
        qvz = tvx * e1y - tvy * e1x
        inv = torch.reciprocal(torch.where(det == 0.0, 1.0, det))
        u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
        v = (ddx * qvx + ddy * qvy + ddz * qvz) * inv
        t_diff = (e2x * qvx + e2y * qvy + e2z * qvz) * inv
        eps = config.eps
        valid = ((det.abs() >= eps) & (u >= eps) & (v >= eps)
                 & (u + v <= 1.0 + eps) & (t_diff >= eps))
        # the differentiable t where the recompute accepts the hit, the
        # traversal's t otherwise (epsilon-edge cases)
        t = torch.where(valid & mask, t_diff, hit.t)

        px = origin[0] + t * dx
        py = origin[1] + t * dy
        pz = origin[2] + t * dz
        # object-frame unit normal normalize(e1 x e2), rotated to world
        cnx = e1y * e2z - e1z * e2y
        cny = e1z * e2x - e1x * e2z
        cnz = e1x * e2y - e1y * e2x
        inv_n = torch.rsqrt(torch.clamp_min(
            cnx * cnx + cny * cny + cnz * cnz, 1e-30))
        nx_, ny_, nz_ = cnx * inv_n, cny * inv_n, cnz * inv_n
        nwx = m[0, 0] * nx_ + m[0, 1] * ny_ + m[0, 2] * nz_
        nwy = m[1, 0] * nx_ + m[1, 1] * ny_ + m[1, 2] * nz_
        nwz = m[2, 0] * nx_ + m[2, 1] * ny_ + m[2, 2] * nz_
        rr, rg, rb = phong_radiance_c((px, py, pz), (nwx, nwy, nwz),
                                      (dx, dy, dz), (cr, cg, cb),
                                      scene.phong)
        new = (rr, rg, rb, nwx, nwy, nwz, px, py, pz)
        acc = [torch.where(mask, n, a) for n, a in zip(new, acc)]

    radiance = torch.stack(acc[0:3], dim=-1)
    normal = torch.stack(acc[3:6], dim=-1)
    point = torch.stack(acc[6:9], dim=-1)
    return radiance, normal, point, hit.tri >= 0


def render_rays(scene: Scene, origin: torch.Tensor, rmd: torch.Tensor,
                config: RenderConfig, accel=None, band_h: int | None = None,
                band_w: int | None = None, proj=None, frames=None) -> dict:
    """Flat-ray pipeline (trace + shade + compose); a dict of flat per-ray
    tensors. The trace runs without gradients (hit topology is discrete)."""
    hit = trace_rays(scene, origin, rmd, config, accel, band_h, band_w, proj,
                     frames)
    return shade_and_compose(scene, origin, rmd, hit, config)


def shade_compose_reference(scene: Scene, origin: torch.Tensor,
                            rmd: torch.Tensor, hit: Hit,
                            config: RenderConfig) -> dict:
    """`shade_hits` and `compose_framebuffer`: the plain, differentiable
    version of `shade_and_compose` (kernel K10's plain twin,
    ``ops/cuda/shade.py``)."""
    radiance, normal, point, hit_mask = shade_hits(scene, origin, rmd, hit,
                                                   config)
    image = compose_framebuffer(radiance, hit_mask, config.background_rgb)
    return dict(image=image,
                radiance=torch.where(hit_mask[..., None], radiance, 0.0),
                hit_t=hit.t, hit_tri=hit.tri, hit_obj=hit.obj,
                normal=normal, point=point)


def shade_and_compose(scene: Scene, origin: torch.Tensor, rmd: torch.Tensor,
                      hit: Hit, config: RenderConfig) -> dict:
    """Shade the hits and compose the image: `render_rays`'s dict of flat
    per-ray tensors for a given hit (the sharded paths combine hits across
    ranks first). With autograd on and an input that requires grad (the
    training steps) the differentiable `shade_compose_reference`; else
    (`render`, `render_jit`, the sharded serving paths) `shade_compose`,
    kernel K10 on CUDA tensors and the same plain version on CPU tensors,
    bit for bit."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (rmd, origin, hit.t,
                                      *scene.parameters())):
        return shade_compose_reference(scene, origin, rmd, hit, config)
    return shade_compose(scene, origin, rmd, hit, config)


def render_differentiable(scene: Scene, camera: Camera,
                          config: RenderConfig = RenderConfig(), accel=None
                          ) -> RenderOutput:
    """One frame on the scene's device, differentiable with respect to the
    scene's and the camera's parameters (the JAX package's ``render``).
    ``accel``: one `ClusterAccel` per object for the cluster methods, one
    `KDTables` per object for "kd". The set-up (rays, Projection, the
    objects' frames) is `set_up_frame`'s: kernel K11 on the card unless a
    camera leaf needs autograd."""
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
    """Whether `render_jit` and `make_train_step_jit` capture
    ``config.method`` on CUDA (every method but "raster"; "kd" since its
    traversal is kernel K7, with no host read)."""
    return config.method not in _UNCAPTURED


def bin_entry_count(scene: Scene, camera: Camera, config: RenderConfig,
                    row0: int = 0, band_h: int | None = None) -> int:
    """The largest live entry count of the frame's bin tables: the probe
    that picks a key's first bucket (one uncaptured prepass an object).
    ``row0`` and ``band_h``: a band's first row and height (the sharded
    paths), else the whole frame. It reads no rays, so none are made."""
    from ..accel.traverse import bin_object
    with torch.no_grad():
        setup = set_up_frame(camera, [obj.pose for obj in scene.objects],
                             "bin", row0, band_h, rays=False)
        return max(bin_object(frame.origin, obj.tris, frame.proj, config,
                              band_h or camera.res_h - row0,
                              camera.res_w)[1].num_entries
                   for obj, frame in zip(scene.objects, setup.objects))


# render_jit's graphs, one memory pool (utils/graphs.py `GraphCache`)
FRAME_GRAPHS = graphs.GraphCache()


def render_jit(scene: Scene, camera: Camera,
               config: RenderConfig = RenderConfig(), accel=None
               ) -> RenderOutput:
    """`render` compiled: on CUDA the frame is captured into a CUDA graph,
    one a key (the config, the scene's and camera's leaf shapes, dtypes and
    device, the resolution, the ``accel`` objects) and bucket, and each
    call copies the scene's and camera's leaves into the graph's inputs,
    replays it and returns clones of its outputs, which no later call
    overwrites. The outputs are bitwise `render`'s.

    Method "bin" sizes its tables at a bucket of the live entry count
    (`utils/graphs.py`): the frame's only host read is the live count after
    the replay, and a frame that outgrew its bucket is captured again at a
    larger one and replayed, so nothing is dropped. Every other method makes
    no host read; "kd" replays its traversal kernel K7 inside the graph.
    "raster" (a dense list sized from the live count) is not captured: it
    runs as `render` does (`jit_captures` says which). A capture that fails
    raises; nothing falls back to the uncaptured frame.

    On the CPU there is no graph: the frame runs as `render`'s, with the
    bin tables at the bucket and the same growth check.

    `FRAME_GRAPHS` is the `GraphCache` (captures, buckets, regrowths). The
    call runs in the span ``rt.render_jit`` (`utils/profiling.py`).
    """
    with span("rt.render_jit"):
        if not jit_captures(config):
            return render(scene, camera, config, accel)
        key = (config, graphs.signature((scene, camera)),
               camera.res_h, camera.res_w,
               None if accel is None else tuple(id(a) for a in accel))

        def body(args, bucket):
            scene_, camera_ = args
            with torch.no_grad(), bin_budget(bucket) as budget:
                out = render_differentiable(scene_, camera_, config, accel)
            return out, budget

        probe = ((lambda args: bin_entry_count(*args, config))
                 if config.method == "bin" else None)
        return FRAME_GRAPHS.run(key, (scene, camera), body, probe,
                                config.bin_chunk, pin=accel)
