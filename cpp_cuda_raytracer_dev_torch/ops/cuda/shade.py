"""Shading and composition: kernel K10 (``csrc/shade.cu``), the
counterpart of the JAX package's XLA-fused plain code in ``shade_hits``
(``models/shading.py``) and ``ops/shade.py``, and its backward, kernel K12
(the same source), the counterpart of that code's autograd; the frame's
set-up: kernel K11 (the same source), the counterpart of the plain code of
``Camera.ray_directions`` / ``projection`` (``models/camera.py``) and the
pose transforms of ``trace_rays``; and its backward, kernel K13 (the same
source), the counterpart of the rays' autograd. None is a Pallas kernel.

- `shade_compose` is K10's launcher: `render_rays`'s dict of flat per-ray
  outputs for given hits, without autograd. For CUDA tensors it launches
  the hand-written kernel (one thread a ray, templated over float32 and
  float64; up to `max_objects` objects a launch, so any number of objects
  take several) and raises if the launch fails, an operand is not one it
  takes or the tensors are on another device. Its plain version is
  ``models/shading.py`` `shade_compose_reference`; the two agree bit for
  bit. `shade_compose.launches` counts kernel launches; inside a captured
  CUDA graph that is the capture's launch, not the replays'.

``models/shading.py`` `shade_compose` chooses between the two by device,
for the serving frames and the training steps' forward.

- `shade_grad` is K12's launcher, that Function's backward on the card:
  for CUDA tensors it launches the kernel (up to `max_objects` objects a
  launch) and raises if a launch fails, an operand is not one it takes or
  the tensors are on another device (the Function takes the plain twin,
  ``models/shade_grad.py`` `shade_grad_reference`, for CPU tensors). The
  two agree bit for bit. `shade_grad.launches` counts its launches.

- `frame_setup` is K11's wrapper: on CUDA tensors (a camera's six leaves,
  each object's quaternion and translation) it writes the rays of a band
  of rows, the constants of the camera's and each object's Projection and
  origin, and the object-frame rays where asked for (one thread a few
  rays, templated over float32 and float64; up to `max_objects` objects a
  launch), and raises if a launch fails or an operand is not one it takes.
  `frame_setup.launches` counts its launches.

``models/camera.py`` `set_up_frame` calls it on CUDA tensors, and
assembles the frame's `FrameSetup` from its outputs (every frame, probe
and training step; on CPU tensors it runs the plain version,
`frame_setup_reference`). The two agree bit for bit.

- `frame_setup_grad` is K13's launcher, the backward of the autograd
  Function that `set_up_frame` takes where a camera leaf needs autograd:
  for CUDA tensors it launches the kernel's ray pass, sums its partials
  and launches its chain, and raises if a launch fails or an operand is not
  one it takes (the Function takes the plain twin, ``models/setup_grad.py``
  `frame_setup_grad_reference`, for CPU tensors). The two agree bit for
  bit. `frame_setup_grad.launches` counts its calls.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPES = (torch.float32, torch.float64)
_TRI_FIELDS = ("p1x", "p1y", "p1z", "e1x", "e1y", "e1z", "e2x", "e2y", "e2z")
_fn = []


def _lib():
    if not _fn:
        lib = _build.load("shade")
        lib.shade_max_objects.restype = ctypes.c_int
        lib.shade_compose_launch.argtypes = (
            [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2 + [ctypes.c_double]
            + [ctypes.c_void_p] * 3)
        lib.shade_compose_launch.restype = ctypes.c_int
        lib.frame_setup_launch.argtypes = (
            [ctypes.c_int] * 8 + [ctypes.c_void_p] * 4 + [ctypes.c_double] * 2
            + [ctypes.c_void_p] * 3)
        lib.frame_setup_launch.restype = ctypes.c_int
        lib.shade_grad_launch.argtypes = (
            [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2 + [ctypes.c_double]
            + [ctypes.c_void_p] * 3)
        lib.shade_grad_launch.restype = ctypes.c_int
        lib.frame_setup_grad_launch.argtypes = (
            [ctypes.c_int] * 5 + [ctypes.c_void_p] + [ctypes.c_double] * 2
            + [ctypes.c_void_p] * 3)
        lib.frame_setup_grad_launch.restype = ctypes.c_int
        lib.frame_setup_chain_launch.argtypes = (
            [ctypes.c_int] * 3 + [ctypes.c_void_p] + [ctypes.c_double] * 2
            + [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 2)
        lib.frame_setup_chain_launch.restype = ctypes.c_int
        _fn.append(lib)
    return _fn[0]


def max_objects() -> int:
    """The objects one launch serves."""
    return _lib().shade_max_objects()


def _check(scene, origin, rmd, hit):
    dt, dev = rmd.dtype, rmd.device
    if rmd.dim() != 2 or rmd.shape[1] != 3 or dt not in _DTYPES:
        raise ValueError(f"rmd must be (R, 3) float32 or float64, got "
                         f"{tuple(rmd.shape)} {dt}")
    num_r = rmd.shape[0]
    if not len(scene.objects):
        raise ValueError("the scene has no objects")
    if origin.shape != (3,) or origin.device != dev:
        raise ValueError(f"origin must be (3,) on {dev}")
    for name, x, dtype in (("hit.t", hit.t, dt),
                           ("hit.tri", hit.tri, torch.int32),
                           ("hit.obj", hit.obj, torch.int32)):
        if x.shape != (num_r,) or x.dtype != dtype or x.device != dev:
            raise ValueError(f"{name} must be ({num_r},) {dtype} on {dev}, "
                             f"got {tuple(x.shape)} {x.dtype} on {x.device}")
    for obj in scene.objects:
        t_n = obj.tris.p1x.shape[0]
        for f in _TRI_FIELDS:
            x = getattr(obj.tris, f)
            if x.shape != (t_n,) or x.dtype != dt or x.device != dev:
                raise TypeError(f"the triangles' {f} must be ({t_n},) {dt} "
                                f"on {dev} like the rays, got "
                                f"{tuple(x.shape)} {x.dtype} on {x.device}")
        c = obj.tris.color
        if c.shape != (t_n, 3) or c.dtype != dt or c.device != dev:
            raise TypeError(f"the triangles' color must be ({t_n}, 3) {dt} "
                            f"on {dev}, got {tuple(c.shape)} {c.dtype}")
        q, t = obj.pose.quat, obj.pose.translation
        if q.shape != (4,) or q.dtype != dt or q.device != dev \
                or t.shape != (3,) or t.device != dev:
            raise TypeError(f"the pose must be a (4,) {dt} quaternion and "
                            f"a (3,) translation on {dev}, got "
                            f"{tuple(q.shape)} {q.dtype}, {tuple(t.shape)}")


def shade_compose(scene, origin: torch.Tensor, rmd: torch.Tensor, hit,
                  config) -> dict:
    """The frame's flat outputs for unit rays ``rmd`` (R, 3) from the world
    origin ``origin`` (3,) and their nearest ``hit`` (a `Hit` over
    ``scene``'s objects): image (R, 3) uint8, radiance, hit_t, hit_tri,
    hit_obj, normal, point (R, 3), as `shade_compose_reference`. Raises
    on tensors of any device but CUDA."""
    _check(scene, origin, rmd, hit)
    dev = rmd.device
    if dev.type != "cuda":
        raise ValueError(f"no shade_compose kernel for {dev}")
    out = _launch(scene, origin, rmd, hit, config)
    return dict(image=out[0], radiance=out[1], hit_t=hit.t, hit_tri=hit.tri,
                hit_obj=hit.obj, normal=out[2], point=out[3])


shade_compose.launches = 0


def _operands(scene, origin, rmd, hit) -> list:
    """K10's and K12's per-ray and scalar operands, contiguous: rmd, the
    world origin, hit t, triangle and object ids, light_pos, light_color,
    diffuse, specular, exponent. A device parameter is cast to the rays'
    dtype, as the plain version's 0-dim operands are."""
    dt, phong = rmd.dtype, scene.phong
    return [rmd.contiguous(), origin.to(dt).contiguous(), hit.t.contiguous(),
            hit.tri.contiguous(), hit.obj.contiguous(),
            *(x.to(dt).contiguous() for x in (
                phong.light_pos, phong.light_color, phong.diffuse,
                phong.specular, phong.exponent))]


def _object_groups(scene, dt):
    """(obj0, tensors) for each launch's objects [obj0, obj0 +
    `max_objects`): 12 an object, p1x .. e2z, colour, the quaternion and
    the translation (cast to the rays' dtype ``dt``)."""
    per = max_objects()
    for obj0 in range(0, len(scene.objects), per):
        group = []
        for obj in scene.objects[obj0:obj0 + per]:
            tris = obj.tris
            group += [getattr(tris, f).contiguous() for f in _TRI_FIELDS]
            group += [tris.color.contiguous(), obj.pose.quat.contiguous(),
                      obj.pose.translation.to(dt).contiguous()]
        yield obj0, group


def _launch(scene, origin, rmd, hit, config):
    """K10's launches on checked operands: (image, radiance, normal,
    point)."""
    dt, dev = rmd.dtype, rmd.device
    num_r = rmd.shape[0]
    image = torch.empty((num_r, 3), dtype=torch.uint8, device=dev)
    radiance, normal, point = (torch.empty((num_r, 3), dtype=dt, device=dev)
                               for _ in range(3))
    if num_r == 0:
        return image, radiance, normal, point
    keep = _operands(scene, origin, rmd, hit)
    ops = (ctypes.c_void_p * len(keep))(*(x.data_ptr() for x in keep))
    outs = (ctypes.c_void_p * 4)(image.data_ptr(), radiance.data_ptr(),
                                 normal.data_ptr(), point.data_ptr())
    bg = (ctypes.c_double * 3)(*(float(c) for c in config.background_rgb))
    n_total = len(scene.objects)
    for obj0, group in _object_groups(scene, dt):
        keep += group
        ptrs = (ctypes.c_void_p * len(group))(*(x.data_ptr() for x in group))
        err = _lib().shade_compose_launch(
            num_r, obj0, len(group) // 12, n_total, int(obj0 == 0),
            int(dt == torch.float64), ptrs, ops, float(config.eps), bg, outs,
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"shade_compose kernel launch failed: CUDA "
                               f"error {err}")
        shade_compose.launches += 1
    return image, radiance, normal, point


# ---- K11: the frame's set-up ----

# K11's constants buffer (kFrameConsts, kObjConsts in csrc/shade.cu): the
# camera's origin, n, u, v, sx, sy, adjust_x, adjust_y, then each object's
# origin, n, u, v
FRAME_CONSTS, OBJ_CONSTS = 16, 12


def _check_camera(camera_leaves, kernel: str, res_h: int, row0: int,
                  band_h: int) -> list:
    """K11's and K13's camera operands: six leaves (pos, look_at, up (3,);
    film_w, film_h, focal ()) of one float dtype on the card, and rows
    [row0, row0 + band_h) of the frame."""
    cam = list(camera_leaves)
    if len(cam) != 6:
        raise ValueError("six camera leaves")
    dt, dev = cam[0].dtype, cam[0].device
    if dev.type != "cuda":
        raise ValueError(f"no {kernel} kernel for {dev}")
    if dt not in _DTYPES:
        raise ValueError(f"the camera must be float32 or float64, not {dt}")
    if not 0 <= row0 <= row0 + band_h <= res_h:
        raise ValueError(f"rows [{row0}, {row0 + band_h}) are not rows of "
                         f"a frame {res_h} high")
    for i, x in enumerate(cam):
        want = (3,) if i < 3 else ()
        if x.shape != want or x.dtype != dt or x.device != dev:
            raise TypeError(f"camera leaf {i} must be {want} {dt} on {dev}, "
                            f"got {tuple(x.shape)} {x.dtype} on {x.device}")
    return cam


def frame_setup(camera_leaves, quats, trans, res_w: int, res_h: int,
                row0: int, band_h: int, adjust_x: float, adjust_y: float,
                rays: bool = True, object_rays: bool = True):
    """K11 on CUDA tensors: the set-up of frame rows [row0, row0 + band_h)
    of a ``res_w`` x ``res_h`` camera given by its six leaves (pos,
    look_at, up (3,); film_w, film_h, focal ()) for the objects posed by
    the (4,) ``quats`` and (3,) ``trans``, all of one float dtype.
    ``adjust_x``, ``adjust_y``: the pixel-centre offsets. Returns (``rmd``
    (band_h * res_w, 3), or None without ``rays``; the constants buffer,
    `FRAME_CONSTS` then `OBJ_CONSTS` an object; each object's rays R^T d,
    or None without ``object_rays``). The plain version is
    ``models/camera.py`` `frame_setup_reference`."""
    cam = _check_camera(camera_leaves, "frame_setup", res_h, row0, band_h)
    quats, trans = list(quats), list(trans)
    dt, dev = cam[0].dtype, cam[0].device
    if object_rays and not rays:
        raise ValueError("object-frame rays are made from the rays")
    if len(quats) != len(trans):
        raise ValueError("a translation a quaternion")
    for q, t in zip(quats, trans):
        if q.shape != (4,) or t.shape != (3,) or q.dtype != dt \
                or t.dtype != dt or q.device != dev or t.device != dev:
            raise TypeError(f"a pose must be a (4,) quaternion and a (3,) "
                            f"translation, {dt} on {dev} like the camera, got "
                            f"{tuple(q.shape)} {q.dtype}, {tuple(t.shape)} "
                            f"{t.dtype}")
    num_r = band_h * res_w if rays else 0
    rmd = torch.empty((num_r, 3), dtype=dt, device=dev) if rays else None
    consts = torch.empty((FRAME_CONSTS + OBJ_CONSTS * len(quats),),
                         dtype=dt, device=dev)
    out = [torch.empty((num_r, 3), dtype=dt, device=dev) if object_rays
           else None for _ in quats]
    keep = [x.contiguous() for x in cam]
    cam_ptrs = (ctypes.c_void_p * len(keep))(*(x.data_ptr() for x in keep))
    per = max_objects()
    for obj0 in range(0, max(len(quats), 1), per):
        group_q = [q.contiguous() for q in quats[obj0:obj0 + per]]
        group_t = [t.contiguous() for t in trans[obj0:obj0 + per]]
        keep += group_q + group_t

        def ptrs(xs):
            return (ctypes.c_void_p * per)(*(0 if x is None else x.data_ptr()
                                             for x in xs))
        err = _lib().frame_setup_launch(
            num_r, res_w, res_h, row0, obj0, len(group_q), int(obj0 == 0),
            int(dt == torch.float64), cam_ptrs, ptrs(group_q), ptrs(group_t),
            ptrs(out[obj0:obj0 + per]), adjust_x, adjust_y,
            consts.data_ptr(), 0 if rmd is None else rmd.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"frame_setup kernel launch failed: CUDA "
                               f"error {err}")
        frame_setup.launches += 1
    return rmd, consts, out


frame_setup.launches = 0


# ---- K12: the training shading's backward ----

# K12's partials (kGradCols, kObjGradCols in csrc/shade.cu): the world
# origin, light_pos, light_color, diffuse, specular, exponent; then each
# object's R (row-major) and object-frame origin R^T (o - t)
GRAD_COLS, OBJ_GRAD_COLS = 12, 12


def shade_grad(scene, origin: torch.Tensor, rmd: torch.Tensor, hit, config,
               cts, rows: bool, ray_ct: bool, tri_ct: bool, hit_t_ct: bool):
    """K12: the backward of `shade_compose` for the unit rays ``rmd`` (R, 3)
    on the card from ``origin`` and their ``hit`` over ``scene``, bit for
    bit its plain twin ``models/shade_grad.py`` `shade_grad_reference`
    (which documents the arguments and the outputs). ``cts``: the
    cotangents of radiance, normal and point, (R, 3) each or None, not all
    None. Raises on tensors of any other device."""
    dt, dev, num_r = rmd.dtype, rmd.device, rmd.shape[0]
    if dev.type != "cuda":
        raise ValueError(f"no shade_grad kernel for {dev}")
    _check(scene, origin, rmd, hit)
    cts = [None if c is None else c.contiguous() for c in cts]
    if all(c is None for c in cts):
        raise ValueError("no cotangent: nothing to differentiate")
    for c in cts:
        if c is not None and (c.shape != (num_r, 3) or c.dtype != dt
                              or c.device != dev):
            raise TypeError(f"a cotangent must be ({num_r}, 3) {dt} on "
                            f"{dev}, got {tuple(c.shape)} {c.dtype} on "
                            f"{c.device}")
    n_total = len(scene.objects)

    def empty(shape, on=True):
        return torch.empty(shape, dtype=dt, device=dev) if on else None
    outs = (empty((GRAD_COLS + OBJ_GRAD_COLS * n_total, num_r), rows),
            empty((n_total, 12)), empty((num_r, 3), ray_ct),
            empty((num_r, 12), tri_ct), empty((num_r,), hit_t_ct))
    keep = _operands(scene, origin, rmd, hit)
    ops = (ctypes.c_void_p * len(keep))(*(x.data_ptr() for x in keep))
    ct_ptrs = (ctypes.c_void_p * 3)(*(0 if c is None else c.data_ptr()
                                      for c in cts))
    out_ptrs = (ctypes.c_void_p * 5)(*(0 if x is None else x.data_ptr()
                                       for x in outs))
    mask = sum(1 << k for k, c in enumerate(cts) if c is not None)
    for obj0, group in _object_groups(scene, dt):
        keep += group
        ptrs = (ctypes.c_void_p * len(group))(*(x.data_ptr() for x in group))
        err = _lib().shade_grad_launch(
            num_r, obj0, len(group) // 12, n_total, int(obj0 == 0),
            int(dt == torch.float64), mask, ptrs, ops, float(config.eps),
            ct_ptrs, out_ptrs, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"shade_grad kernel launch failed: CUDA error "
                               f"{err}")
        shade_grad.launches += 1
    return outs


shade_grad.launches = 0


# ---- K13: the training set-up's backward ----

# K13's partials a ray: the cotangent of the unnormalised direction d, then
# ix d's and iy d's (the gradients of n_mod, u_mod and v_mod once summed)
SETUP_GRAD_COLS = 9


def frame_setup_grad(camera_leaves, g_rmd: torch.Tensor, res_w: int,
                     res_h: int, row0: int, adjust_x: float, adjust_y: float,
                     need) -> list:
    """K13 on CUDA tensors: the gradients of the six camera leaves (as
    `frame_setup` takes them) from the cotangent ``g_rmd`` (band_h * res_w,
    3) of K11's rays of frame rows [row0, row0 + band_h), bit for bit its
    plain twin ``models/setup_grad.py`` `frame_setup_grad_reference`.
    ``need``: six flags; returns six tensors, None where a flag is off.
    Two launches with one ``torch.sum`` between: the rays' partials
    (`SETUP_GRAD_COLS` a ray), then the chain to the leaves. Raises on
    tensors of any other device. ``frame_setup_grad.launches`` counts its
    calls (a ray pass and a chain launch each)."""
    need = [bool(x) for x in need]
    if len(need) != 6 or not any(need):
        raise ValueError("need: six flags, one or more set")
    num_r = g_rmd.shape[0] if g_rmd.dim() == 2 else -1
    if num_r < 1 or num_r % res_w or g_rmd.shape[1] != 3:
        raise ValueError(f"g_rmd must be (band_h * {res_w}, 3), got "
                         f"{tuple(g_rmd.shape)}")
    cam = _check_camera(camera_leaves, "frame_setup_grad", res_h, row0,
                        num_r // res_w)
    dt, dev = cam[0].dtype, cam[0].device
    if g_rmd.dtype != dt or g_rmd.device != dev:
        raise TypeError(f"g_rmd must be {dt} on {dev} like the camera, got "
                        f"{g_rmd.dtype} on {g_rmd.device}")
    keep = [x.contiguous() for x in cam] + [g_rmd.contiguous()]
    cam_ptrs = (ctypes.c_void_p * 6)(*(x.data_ptr() for x in keep[:6]))
    partials = torch.empty((SETUP_GRAD_COLS, num_r), dtype=dt, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    is_f64 = int(dt == torch.float64)
    err = _lib().frame_setup_grad_launch(
        num_r, res_w, res_h, row0, is_f64, cam_ptrs, adjust_x, adjust_y,
        keep[6].data_ptr(), partials.data_ptr(), stream)
    if err == 0:
        sums = partials.sum(dim=1)
        out = torch.empty((12,), dtype=dt, device=dev)
        err = _lib().frame_setup_chain_launch(
            res_w, res_h, is_f64, cam_ptrs, adjust_x, adjust_y,
            sums.data_ptr(), sum(1 << k for k, on in enumerate(need) if on),
            out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"frame_setup_grad kernel launch failed: CUDA "
                           f"error {err}")
    frame_setup_grad.launches += 1
    views = (out[0:3], out[3:6], out[6:9], out[9], out[10], out[11])
    return [v if on else None for v, on in zip(views, need)]


frame_setup_grad.launches = 0
