"""Sharded rendering and training over a device mesh (the JAX package's
``parallel/render_pjit.py``), on ``torch.distributed``.

The image's rows are sharded over the mesh's "rays" axis: each rank
renders its own band of rows with the scene and camera replicated (the
bin and raster paths take the band's Projection, ``row0`` set; the cluster
paths take the replicated ``accel``). Optionally each object's triangle
range (`render_sharded_2d`, `render_sharded_2d_bin`) or cluster range
(`render_sharded_2d_accel`, over `shard_accel`) is also sharded over
"prims", and the per-ray nearest hit is min-combined across it
(parallel/collectives.py) before shading.

The program is SPMD (parallel/mesh.py): every rank calls the same entry
point. Where JAX's ``shard_map`` output is one global array, every rank
here gets the whole frame: its own band carries autograd, the other
ranks' bands arrive by an all-gather over "rays" as constants. A loss on
that frame therefore has the whole image's value on every rank and this
rank's share of the gradient; `allreduce_gradients` sums the shares over
"rays" (only over "rays": the prim ranks of a band hold the same band's
gradient, which must count once). JAX's ``jax.grad`` through ``shard_map``
does that sum by itself.

`make_loss_fn` / `make_train_step` with ``mesh=None`` are the single-device
step. ``params`` is ``{"scene": Scene, "camera": Camera}``; the optimizer is
a ``torch.optim`` optimizer over the parameters to train
(``torch.optim.SGD`` without momentum is ``optax.sgd``). Parameters left
out of it, or with ``requires_grad`` off, stay fixed: with the triangle
tables frozen the step is the pose/light/camera-only step of ``bench.py``
and the gather backward (kernel K2) does not run. With a mesh each rank
computes the loss of its band, scaled as the whole image's mean (band sum
/ (H·W·3)), reports the loss summed over "rays", and sums the gradients
before the optimizer steps.

`make_train_step_jit` is `make_train_step` compiled, with or without a
mesh: on CUDA two captured graphs a step, the forward and backward (with a
mesh, the collectives too), then the optimizer's step (utils/graphs.py).
`render_sharded_jit` is `render_sharded` compiled: each rank replays its
band's frame and the all-gather of the bands. Every rank captures its own
graphs and the ranks stay in lockstep: the bin table's bucket is agreed
over the mesh (`agreed_max`), so that every rank regrows, warms up and
captures at the same call and the captured collectives pair up.

One deliberate difference: the port traces hits without gradients and
shades differentiably on every path, so `render_sharded_2d` is
differentiable; JAX's is not (its nearest-hit ``pmin`` has no
differentiation rule, ROADMAP F11).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..models.camera import Camera, set_up_frame
from ..accel.methods import INTERSECTS
from ..models.renderer import (RenderOutput, bucket_probe, budget,
                               compiled_frame, jit_captures,
                               render_differentiable, render_rays,
                               shade_and_compose, trace_rays)
from ..models.scene import Scene
from ..ops.intersect import Hit
from ..utils import graphs
from ..utils.config import RenderConfig
from ..utils.profiling import span
from .collectives import allreduce_nearest_hit
from .mesh import (PRIMS_AXIS, RAYS_AXIS, axis_group, axis_index, axis_size,
                   check_mesh, ray_band)

_FAR = 3.0e38
_TRI_FIELDS = ("p1x", "p1y", "p1z", "e1x", "e1y", "e1z", "e2x", "e2y",
               "e2z")


def _check_band(camera: Camera, mesh) -> tuple[int, int]:
    """(row0, band_h) of this rank's band; res_h must divide over
    "rays"."""
    return ray_band(check_mesh(mesh), camera.res_h)


def _band_setup(scene: Scene, camera: Camera, method: str, row0: int,
                band_h: int):
    """The `FrameSetup` of the band's rows (`set_up_frame`): the rays, flat
    (band_h * W, 3), the same values as the whole frame's (ray generation
    is elementwise), and the camera Projection with ``row0`` set. Pixel
    coordinates are affine, so a band window is an adjust_y shift, which
    the bin prepass and raster apply (`Projection.band_local`); the bin
    path's ray table counts rows from ``row0`` of the frame, so its rays
    are bitwise the frame's (the JAX package regenerates them from the
    shifted projection)."""
    return set_up_frame(camera, [obj.pose for obj in scene.objects], method,
                        row0, band_h)


def _whole_frame(flat: dict, mesh, band_h: int, w: int) -> RenderOutput:
    """Flat per-ray band outputs -> the whole (H, W, ...) frame on every
    rank: an all-gather over "rays" of the detached bands, this rank's own
    band put back live so that autograd reaches it."""
    n = axis_size(mesh, RAYS_AXIS)
    group = axis_group(mesh, RAYS_AXIS)
    me = axis_index(mesh, RAYS_AXIS)
    out = {}
    for k, v in flat.items():
        v = v.reshape(band_h, w, *v.shape[1:])
        if n > 1:
            parts = [torch.empty_like(v) for _ in range(n)]
            dist.all_gather(parts, v.detach().contiguous(), group=group)
            parts[me] = v
            v = torch.cat(parts)
        out[k] = v
    return RenderOutput(**out)


def render_sharded(scene: Scene, camera: Camera, config: RenderConfig,
                   mesh, accel=None) -> RenderOutput:
    """Forward frame with image rows sharded over the mesh's "rays" axis
    (replicated over "prims" on a 2-D mesh). Any method; the cluster and
    kd methods take ``accel`` (one per object, replicated). Differentiable
    like `render_differentiable`; every rank returns the whole frame."""
    row0, band_h = _check_band(camera, mesh)
    setup = _band_setup(scene, camera, config.method, row0, band_h)
    flat = render_rays(scene, camera.pos, setup.rmd, config, accel, band_h,
                       camera.res_w, proj=setup.proj, frames=setup.objects)
    return _whole_frame(flat, mesh, band_h, camera.res_w)


def agreed_max(mesh):
    """`utils/graphs.py` ``agree`` for a mesh: ``agree(count)``, the
    maximum of a count (an int, or a tensor of one or two counts on this
    rank's device) over every rank of the mesh, as an int or a tuple of
    ints, elementwise (one MAX all-reduce of 8 or 16 bytes a mesh
    dimension, then one host read). Every rank must call it at the same
    point of the program."""
    groups = [mesh.get_group(name) for name in mesh.mesh_dim_names]
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device("cpu"))

    def agree(count) -> int:
        n = torch.as_tensor(count).to(dev, torch.int64, copy=True).reshape(-1)
        for group in groups:
            dist.all_reduce(n, op=dist.ReduceOp.MAX, group=group)
        return int(n) if n.numel() == 1 else tuple(n.tolist())
    return agree


def _band(camera: Camera, mesh) -> tuple[int, int | None]:
    """(row0, band_h) of this rank's band, (0, None) without a mesh: the
    rows a compiled frame or step probes (`bucket_probe`)."""
    return (0, None) if mesh is None else _check_band(camera, mesh)


# render_sharded_jit's graphs: one `GraphCache` a mesh, as (mesh, cache)
SHARDED_GRAPHS: list = []


def sharded_graphs(mesh) -> graphs.GraphCache:
    """The `GraphCache` of `render_sharded_jit` on ``mesh`` (made at the
    mesh's first use, with `agreed_max`; it keeps the mesh)."""
    for m, cache in SHARDED_GRAPHS:
        if m is mesh:
            return cache
    cache = graphs.GraphCache(agree=agreed_max(check_mesh(mesh)))
    SHARDED_GRAPHS.append((mesh, cache))
    return cache


def render_sharded_jit(scene: Scene, camera: Camera, config: RenderConfig,
                       mesh, accel=None) -> RenderOutput:
    """`render_sharded` compiled, the counterpart of
    ``jax.jit(render_sharded)`` (``models/renderer.py`` `compiled_frame`):
    on CUDA each rank replays one captured graph a frame, its band's frame
    and the all-gather of the bands over "rays", and returns clones of the
    whole frame. Every rank of an SPMD program hits or misses its cache at
    the same call. The bin bucket is agreed over the mesh: the first call
    takes the largest band's probe, and after each replay the ranks
    all-reduce their live counts (MAX), so that every rank regrows,
    captures again and replays at the same call. A method that
    `jit_captures` does not capture runs as `render_sharded` does, without
    gradients. On the CPU (gloo) there are no graphs: the same bucketed
    body runs, with the same agreed growth check.

    `sharded_graphs(mesh)` is the mesh's `GraphCache`."""
    if not jit_captures(config):
        with torch.no_grad():
            return render_sharded(scene, camera, config, mesh, accel)
    return compiled_frame(sharded_graphs(mesh), render_sharded, scene,
                          camera, config, accel, mesh,
                          band=_band(camera, mesh))


@dataclasses.dataclass
class _TriRange:
    """A contiguous range of an object's triangles (detached, padded with
    zero triangles), with the `Triangles` views the intersects read."""

    p1x: torch.Tensor
    p1y: torch.Tensor
    p1z: torch.Tensor
    e1x: torch.Tensor
    e1y: torch.Tensor
    e1z: torch.Tensor
    e2x: torch.Tensor
    e2y: torch.Tensor
    e2z: torch.Tensor

    @property
    def p1(self):
        return torch.stack([self.p1x, self.p1y, self.p1z], dim=-1)

    @property
    def e1(self):
        return torch.stack([self.e1x, self.e1y, self.e1z], dim=-1)

    @property
    def e2(self):
        return torch.stack([self.e2x, self.e2y, self.e2z], dim=-1)


def _shard_tris(tris, pi: int, nprims: int) -> tuple[_TriRange, int]:
    """Slots [pi * chunk, (pi + 1) * chunk) of the triangles padded with
    zero triangles to nprims * chunk. A zero triangle has det = 0, so no
    intersect accepts it (the bin prepass may still give it an entry where
    its point projects on screen; kernel K1's det test rejects it)."""
    t = tris.p1x.shape[0]
    chunk = -(-t // nprims)
    lo, hi = pi * chunk, (pi + 1) * chunk

    def cut(x):
        x = x.detach()[lo:min(hi, t)]
        if x.shape[0] < chunk:
            x = torch.cat([x, x.new_zeros(chunk - x.shape[0])])
        return x
    return _TriRange(*(cut(getattr(tris, f)) for f in _TRI_FIELDS)), chunk


def _prims(mesh) -> tuple[int, int]:
    """This rank's prim range and the number of ranges."""
    return axis_index(mesh, PRIMS_AXIS), axis_size(mesh, PRIMS_AXIS)


def _combine(best: Hit, mesh) -> Hit:
    group = axis_group(mesh, PRIMS_AXIS)
    return best if group is None else allreduce_nearest_hit(best, group)


def _shift(hit: Hit, offset: int, oi: int) -> Hit:
    """Shard-local triangle ids -> object-wide ids and the object id."""
    found = hit.tri >= 0
    return Hit(t=hit.t, tri=torch.where(found, hit.tri + offset, -1)
               .to(torch.int32), obj=torch.where(found, oi, -1)
               .to(torch.int32))


def _render_ranges(scene: Scene, camera: Camera, config: RenderConfig,
                   mesh, method: str) -> RenderOutput:
    """The frame on a ("rays", "prims") mesh with this prim rank's range of
    every object's triangles (`_shard_tris`) intersected by ``method``'s
    intersect, ids shifted to the object's and the nearest hit
    min-combined across "prims"; shading runs on the combined hit."""
    row0, band_h = _check_band(camera, mesh)
    pi, nprims = _prims(mesh)
    setup = _band_setup(scene, camera, method, row0, band_h)
    rmd = setup.rmd
    with torch.no_grad():
        best = Hit.miss(rmd.shape[0], config.draw_distance, device=rmd.device,
                        dtype=rmd.dtype)
        for oi, (obj, frame) in enumerate(zip(scene.objects, setup.objects)):
            sub, chunk = _shard_tris(obj.tris, pi, nprims)
            hit = INTERSECTS[method](frame, sub, None, config, band_h,
                                     camera.res_w)
            best = best.merge(_shift(hit, pi * chunk, oi))
        best = _combine(best, mesh)
    flat = shade_and_compose(scene, camera.pos, rmd, best, config)
    return _whole_frame(flat, mesh, band_h, camera.res_w)


def render_sharded_2d(scene: Scene, camera: Camera, config: RenderConfig,
                      mesh) -> RenderOutput:
    """Forward frame on a ("rays", "prims") mesh: rows sharded over "rays"
    and each object's triangle range over "prims". Every prim rank runs the
    fixed-origin oracle (`mt_fixed_origin`) over its own range, the nearest
    hit is min-combined across "prims", and shading runs on the combined
    hit. The ``config.method`` is not read (the JAX function has the same
    contract). Differentiable through the shading (ROADMAP F11)."""
    return _render_ranges(scene, camera, config, mesh, "fixed")


def shard_accel(accel, nprims: int):
    """Split a `ClusterAccel` into ``nprims`` contiguous cluster ranges,
    stacked on a new leading axis: every tensor field gets shape
    (nprims, C / nprims, ...) (as the JAX function's arrays; rank p takes
    index p). Clusters are in KD-leaf order, so each range is spatially
    coherent. Padding clusters are inverted-empty boxes (every frustum
    plane test fails, so never a candidate) with zero geometry (an all-zero
    slot is never accepted, so K4's and K5's fill cut skips it) and
    ``slot_mat`` -1."""
    from ..accel.traverse import ClusterAccel

    c = accel.num_clusters
    cp = -(-c // nprims)
    pad = cp * nprims - c

    def cut(x, fill):
        if pad:
            x = torch.cat([x, torch.full((pad, *x.shape[1:]), fill,
                                         dtype=x.dtype, device=x.device)])
        return x.reshape(nprims, cp, *x.shape[1:])

    return ClusterAccel(bounds_min=cut(accel.bounds_min, _FAR),
                        bounds_max=cut(accel.bounds_max, -_FAR),
                        centers=cut(accel.centers, 0.0),
                        geom9=cut(accel.geom9, 0.0),
                        slot_mat=cut(accel.slot_mat, -1),
                        leaf_size=accel.leaf_size)


def _accel_shard(stacked, p: int):
    """Rank ``p``'s cluster range of a `shard_accel` result."""
    return dataclasses.replace(
        stacked, **{f: getattr(stacked, f)[p] for f in
                    ("bounds_min", "bounds_max", "centers", "geom9",
                     "slot_mat")})


def render_sharded_2d_accel(scene: Scene, camera: Camera,
                            config: RenderConfig, mesh, accel
                            ) -> RenderOutput:
    """The cluster paths ("pallas2", "pallas", "grid") on a ("rays",
    "prims") mesh: rows sharded over "rays", each object's cluster ranges
    (`shard_accel`) over "prims". Every prim rank culls and intersects
    only its own clusters (kernel K4 or K5); the nearest hit is
    min-combined across "prims" and shading runs on the combined hit."""
    row0, band_h = _check_band(camera, mesh)
    pi, nprims = _prims(mesh)
    setup = _band_setup(scene, camera, config.method, row0, band_h)
    rmd = setup.rmd
    local = tuple(_accel_shard(shard_accel(a, nprims), pi) for a in accel)
    hit = trace_rays(scene, camera.pos, rmd, config, local, band_h,
                     camera.res_w, frames=setup.objects)
    with torch.no_grad():
        hit = _combine(hit, mesh)
    flat = shade_and_compose(scene, camera.pos, rmd, hit, config)
    return _whole_frame(flat, mesh, band_h, camera.res_w)


def render_sharded_2d_bin(scene: Scene, camera: Camera,
                          config: RenderConfig, mesh) -> RenderOutput:
    """The bin path on a ("rays", "prims") mesh: rows sharded over "rays"
    and each object's triangle range over "prims". Every prim rank bins and
    intersects (kernel K1) only its own range against its band (binning a
    subset is still exact for that subset), the nearest hit is
    min-combined across "prims", and shading runs on the combined hit;
    winner ids are shifted by the range's offset, so shading reads the whole
    replicated tables. An exact t tie across ranges goes to the lowest id;
    inside a range K1 keeps the earlier block (ROADMAP F2)."""
    if config.with_stats:
        raise ValueError("with_stats makes intersect_binned return "
                         "(Hit, stats); call it directly for telemetry "
                         "(models/renderer.py trace_rays has the same "
                         "contract)")
    return _render_ranges(scene, camera, config, mesh, "bin")


def radiance_sharded(scene: Scene, camera: Camera, config: RenderConfig,
                     mesh, accel=None) -> torch.Tensor:
    """The sharded radiance image (H, W, 3), this rank's band live."""
    return render_sharded(scene, camera, config, mesh, accel).radiance


def allreduce_gradients(parameters, mesh) -> None:
    """Sum the ``.grad`` of replicated parameters over the mesh's "rays"
    axis, in place, in one collective per dtype. A parameter that requires
    a gradient but got none counts as zeros, so every rank reduces the same
    layout."""
    params = [p for p in parameters if p.requires_grad]
    n = axis_size(check_mesh(mesh), RAYS_AXIS)
    if n == 1 or not params:
        return
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    group = axis_group(mesh, RAYS_AXIS)
    by_dtype: dict = {}
    for p in params:
        by_dtype.setdefault(p.grad.dtype, []).append(p)
    for ps in by_dtype.values():
        flat = torch.cat([p.grad.reshape(-1) for p in ps])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        for p, g in zip(ps, flat.split([p.numel() for p in ps])):
            p.grad.copy_(g.view_as(p.grad))


def make_loss_fn(config: RenderConfig, mesh=None, accel=None):
    """L2 image loss ``mean((radiance - target)**2)`` against a target
    (H, W, 3), differentiable with respect to (scene, camera). ``accel``:
    one `ClusterAccel` per object for the cluster methods, built once and
    held fixed (the traversal is discrete; gradients flow through the
    shading only).

    With a mesh the value is the whole image's loss on every rank and the
    gradient is this rank's band's share (sum over the band / (H·W·3));
    `make_train_step` sums the shares."""
    if mesh is not None:
        check_mesh(mesh)

    def loss_fn(params, target: torch.Tensor) -> torch.Tensor:
        scene, camera = params["scene"], params["camera"]
        if mesh is None:
            rad = render_differentiable(scene, camera, config,
                                        accel).radiance
            return torch.mean((rad - target) ** 2)
        row0, band_h = _check_band(camera, mesh)
        setup = _band_setup(scene, camera, config.method, row0, band_h)
        flat = render_rays(scene, camera.pos, setup.rmd, config, accel,
                           band_h, camera.res_w, proj=setup.proj,
                           frames=setup.objects)
        rad = flat["radiance"].reshape(band_h, camera.res_w, 3)
        band = ((rad - target[row0:row0 + band_h]) ** 2).sum() / target.numel()
        total = band.detach().clone()
        group = axis_group(mesh, RAYS_AXIS)
        if axis_size(mesh, RAYS_AXIS) > 1:
            dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        return total + (band - band.detach())
    return loss_fn


def make_train_step(optimizer: torch.optim.Optimizer, config: RenderConfig,
                    mesh=None, accel=None):
    """``step(params, target)``: zero the gradients, backpropagate the
    loss, with a mesh sum the gradients over "rays" (`allreduce_gradients`),
    step the optimizer (updating the parameters in place) and return the
    loss (detached)."""
    loss_fn = make_loss_fn(config, mesh, accel)

    def step(params, target: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, target)
        loss.backward()
        if mesh is not None:
            allreduce_gradients([*params["scene"].parameters(),
                                 *params["camera"].parameters()], mesh)
        optimizer.step()
        return loss.detach()
    return step


def _check_capturable(optimizer: torch.optim.Optimizer) -> None:
    """A captured optimizer step must read nothing back from the host and
    keep its state on the device: ``torch.optim.SGD`` without momentum (=
    ``optax.sgd``), or an optimizer built with ``capturable=True``."""
    groups = optimizer.param_groups
    if isinstance(optimizer, torch.optim.SGD) and all(
            g["momentum"] == 0 for g in groups):
        return
    if all(g.get("capturable", False) for g in groups):
        return
    raise ValueError(
        f"{type(optimizer).__name__} cannot be captured: make_train_step_jit "
        "takes torch.optim.SGD without momentum (optax.sgd) or an optimizer "
        "built with capturable=True; use make_train_step otherwise")


def make_train_step_jit(optimizer: torch.optim.Optimizer,
                        config: RenderConfig, mesh=None, accel=None):
    """`make_train_step` compiled: ``step(params, target)`` with its
    contract (the parameters updated in place, the loss returned detached;
    here a clone that no later step overwrites).

    On CUDA a step replays two captured graphs (utils/graphs.py):
    - G1: the gradients set to None before its capture, so that they come
      from the graph's memory pool and every replay writes them anew; the
      forward, the loss and the backward (the method's kernel, K1 for "bin"
      or K7 for "kd", and K2 inside it); with a mesh, this rank's band, the
      loss's all-reduce and `allreduce_gradients`. Method "bin" sizes its
      tables at a bucket of the live entry count (with a mesh, the band's,
      agreed over the mesh: `agreed_max`).
    - Between the graphs the host reads the live count (with a mesh, after
      its MAX all-reduce); a step whose count outgrew its bucket is
      captured again at a larger one and replayed before any parameter
      changes, so a truncated table never reaches the optimizer. With a
      mesh every rank does so at the same step.
    - G2: ``optimizer.step()``, the cache's `GraphCache.follow`: the first
      step is eager and builds the optimizer's state; no warm-up steps it.
    G1 reads the parameters of ``params`` in place and the caller's target
    through a static copy; a step with other parameters, or a target of
    another shape, captures anew (one pair of graphs is kept). With a mesh
    every rank runs its own graphs and captures anew at the same step.
    A step runs in the span ``rt.train_step``; G2's capture counts in
    ``capture_s`` (`utils/profiling.py`).

    A method that `render_jit` does not capture (`jit_captures`:
    "raster", whose dense list is sized by a host read) is not captured
    here either: its step is `make_train_step`'s, uncaptured, for any
    optimizer. For a captured method the optimizer must capture
    (`_check_capturable`: SGD without momentum, or ``capturable=True``).
    On the CPU there are no graphs: the step runs as `make_train_step`'s,
    with the bin tables at the bucket and the same growth check (with a
    mesh, agreed over gloo). ``step.graphs()`` is the current pair's
    `GraphCache` (its buckets and regrowths).
    """
    if not jit_captures(config):
        return make_train_step(optimizer, config, mesh, accel)
    _check_capturable(optimizer)
    loss_fn = make_loss_fn(config, mesh, accel)
    agree = None if mesh is None else agreed_max(mesh)
    state = {"key": None, "cache": None}

    def forward_backward(params):
        trained = [*params["scene"].parameters(),
                   *params["camera"].parameters()]

        def body(target, bucket):
            optimizer.zero_grad(set_to_none=True)
            with graphs.sized(budget(config, bucket)) as sized:
                loss = loss_fn(params, target)
                loss.backward()
            if mesh is not None:
                allreduce_gradients(trained, mesh)
            return loss.detach(), sized
        return body

    def step(params, target: torch.Tensor) -> torch.Tensor:
        with span("rt.train_step"):
            scene, camera = params["scene"], params["camera"]
            key = (config,
                   tuple(id(p) for p in graphs.leaves((scene, camera))),
                   graphs.signature((scene, camera, target)), camera.res_h,
                   camera.res_w)
            if key != state["key"]:         # one pair of graphs is kept
                state.update(key=key, cache=graphs.GraphCache(agree))
            cache = state["cache"]
            probe, least = bucket_probe(scene, camera, config, accel,
                                        *_band(camera, mesh))
            loss = cache.run(key, target, forward_backward(params), probe,
                             least, pin=(params, accel))
            cache.follow(optimizer.step)
            return loss
    step.graphs = lambda: state["cache"]
    return step
