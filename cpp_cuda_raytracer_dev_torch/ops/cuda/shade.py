"""Serving shading and composition: kernel K10 (``csrc/shade.cu``), the
counterpart of the JAX package's XLA-fused plain code in ``shade_hits``
(``models/renderer.py``) and ``ops/shade.py``; not a Pallas kernel.

- `shade_compose` is the wrapper: `render_rays`'s dict of flat per-ray
  outputs for given hits, without autograd. For CUDA tensors it launches
  the hand-written kernel (one thread a ray, templated over float32 and
  float64; up to `max_objects` objects a launch, so any number of objects
  take several) and raises if the launch fails or an operand is not one it
  takes; for CPU tensors it runs the plain version,
  ``models/renderer.py`` `shade_compose_reference`. Nothing falls back from
  the card to the plain version; the two agree bit for bit.
- `shade_compose.launches` counts kernel launches; inside a captured CUDA
  graph that is the capture's launch, not the replays'.

`models/renderer.py` `shade_and_compose` calls it when autograd is off
(`render`, `render_jit`, the sharded serving paths, the apps); with autograd
on (the training steps) it runs the differentiable plain version.
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
    hit_obj, normal, point (R, 3), as `shade_compose_reference`."""
    _check(scene, origin, rmd, hit)
    dev = rmd.device
    if dev.type == "cpu":
        from ...models.renderer import shade_compose_reference
        return shade_compose_reference(scene, origin, rmd, hit, config)
    if dev.type != "cuda":
        raise ValueError(f"no shade_compose kernel for {dev}")
    out = _launch(scene, origin, rmd, hit, config)
    return dict(image=out[0], radiance=out[1], hit_t=hit.t, hit_tri=hit.tri,
                hit_obj=hit.obj, normal=out[2], point=out[3])


shade_compose.launches = 0


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
    phong = scene.phong

    def flat(x):   # a device parameter in the rays' dtype, as the plain
        return x.to(dt).contiguous()   # version's 0-dim operands are cast
    keep = [rmd.contiguous(), flat(origin), hit.t.contiguous(),
            hit.tri.contiguous(), hit.obj.contiguous(),
            flat(phong.light_pos), flat(phong.light_color),
            flat(phong.diffuse), flat(phong.specular), flat(phong.exponent)]
    ops = (ctypes.c_void_p * len(keep))(*(x.data_ptr() for x in keep))
    outs = (ctypes.c_void_p * 4)(image.data_ptr(), radiance.data_ptr(),
                                 normal.data_ptr(), point.data_ptr())
    bg = (ctypes.c_double * 3)(*(float(c) for c in config.background_rgb))
    per = max_objects()
    n_total = len(scene.objects)
    for obj0 in range(0, n_total, per):
        group = []
        for obj in scene.objects[obj0:obj0 + per]:
            tris = obj.tris
            group += [getattr(tris, f).contiguous() for f in _TRI_FIELDS]
            group += [tris.color.contiguous(), obj.pose.quat.contiguous(),
                      flat(obj.pose.translation)]
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
