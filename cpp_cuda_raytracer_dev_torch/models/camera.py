"""Pinhole camera and primary-ray generation (the JAX package's
``models/camera.py``).

Conventions (reference Camera.cpp:32-67):
  n = normalize(look_at - pos), v = normalize(n x (up x n)), u = v x n
  pixel pitch = film / resolution
  ray(ix, iy) = normalize(n*focal + u_mod*(ix - adjust_x)
                          + v_mod*(iy - adjust_y))
with adjust = res // 2, minus half a pixel when the resolution is even.
Row iy = 0 is the bottom of the image.

A frame's set-up (`FrameSetup`): its rays, the camera's Projection and each
posed object's origin, rays and Projection in the object's frame.
`set_up_frame` is every frame's entry point: kernel K11
(``ops/cuda/shade.py`` `frame_setup`) on CUDA tensors, the plain PyTorch
`frame_setup_reference` on CPU tensors; where a camera leaf needs autograd
(the training steps) the same forward inside an autograd Function whose
backward is kernel K13 (``ops/cuda/shade.py`` `frame_setup_grad`) or its
plain twin (``models/setup_grad.py``).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..ops import vecmath
from ..ops.cuda import shade as k11
from ..ops.cuda.shade import FRAME_CONSTS, OBJ_CONSTS
from ..utils.config import METHODS
from .setup_grad import frame_setup_grad_reference


def _adjust(res: int) -> float:
    return res // 2 - (0.5 if res % 2 == 0 else 0.0)


@dataclasses.dataclass
class Projection:
    """World point -> subpixel coordinates (the inverse of ray generation):
    ix = adjust_x + sx·((p-origin)·u)/((p-origin)·n), iy likewise with
    (v, sy).

    ``row0`` > 0 makes it the projection of a band of the frame whose pixel
    rows start at frame row ``row0`` (the sharded renders): the paths that
    regenerate rays from it do so at the frame's pixel coordinates, so a
    band's rays are bitwise the frame's (a band's own pixel rows are those
    of the projection with adjust_y - row0: `band_local`)."""

    origin: torch.Tensor     # (3,)
    n: torch.Tensor          # (3,) view direction (unit)
    u: torch.Tensor          # (3,) screen-right (unit)
    v: torch.Tensor          # (3,) screen-up (unit)
    sx: torch.Tensor         # scalar focal / pix_w
    sy: torch.Tensor         # scalar focal / pix_h
    adjust_x: torch.Tensor   # scalar pixel-centre offset
    adjust_y: torch.Tensor
    row0: int = 0

    def band_local(self) -> "Projection":
        """The same band with row 0 at its first row: adjust_y - row0."""
        if not self.row0:
            return self
        return dataclasses.replace(self, adjust_y=self.adjust_y - self.row0,
                                   row0=0)

    def transformed(self, pose) -> "Projection":
        """This projection in an object's local frame."""
        return dataclasses.replace(
            self, origin=pose.inv_apply(self.origin),
            n=pose.inv_apply_vec(self.n), u=pose.inv_apply_vec(self.u),
            v=pose.inv_apply_vec(self.v))


class Camera(nn.Module):
    """Pinhole camera. Its six float leaves are ``nn.Parameter``s named by
    the JAX pytree paths (``pos``, ``look_at``, ``up``, ``film_w``,
    ``film_h``, ``focal``), so its gradients compare leaf by leaf with
    ``jax.grad(loss, argnums=(0, 1))``. They are created frozen, as a
    served camera is an input; ``camera.requires_grad_()`` makes them
    trainable. ``res_w`` and ``res_h`` are ints."""

    LEAVES = ("pos", "look_at", "up", "film_w", "film_h", "focal")

    def __init__(self, pos, look_at, up, film_w, film_h, focal,
                 res_w: int = 960, res_h: int = 540):
        super().__init__()
        for name, value in zip(self.LEAVES,
                               (pos, look_at, up, film_w, film_h, focal)):
            setattr(self, name, nn.Parameter(value, requires_grad=False))
        self.res_w, self.res_h = res_w, res_h

    @classmethod
    def create(cls, res_w: int, res_h: int, pos, look_at, up,
               film_h: float = 0.024, focal: float = 0.055,
               film_w: float | None = None, *, device,
               dtype=torch.float32) -> "Camera":
        """Reference construction (WinMain.cpp:69-74):
        film_w = aspect · film_h. ``dtype`` is the camera's precision
        (utils/dtypes.py `Precision`)."""
        if film_w is None:
            film_w = film_h * (res_w / res_h)

        def fp(x):
            return torch.as_tensor(x, dtype=dtype, device=device)
        return cls(pos=fp(pos), look_at=fp(look_at), up=fp(up),
                   film_w=fp(film_w), film_h=fp(film_h), focal=fp(focal),
                   res_w=res_w, res_h=res_h)

    @property
    def num_pixels(self) -> int:
        return self.res_w * self.res_h

    def pixel_pitch(self) -> tuple[torch.Tensor, torch.Tensor]:
        return self.film_w / self.res_w, self.film_h / self.res_h

    def basis(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(n, u, v) orthonormal basis per Camera.cpp:32-58."""
        n = vecmath.normalize(self.look_at - self.pos)
        up = vecmath.normalize(self.up)
        v = vecmath.normalize(vecmath.cross(n, vecmath.cross(up, n)))
        u = vecmath.cross(v, n)
        return n, u, v

    def ray_mods(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(n_mod, u_mod, v_mod) per-pixel ray deltas (Camera.cpp:61-67)."""
        n, u, v = self.basis()
        pix_w, pix_h = self.pixel_pitch()
        u_mod = u * pix_w
        v_mod = v * pix_h
        n_mod = (n * self.focal - v_mod * _adjust(self.res_h)
                 - u_mod * _adjust(self.res_w))
        return n_mod, u_mod, v_mod

    def projection(self) -> Projection:
        """Inverse of ray generation: the constants that map a world point
        to its subpixel coordinates (used by the binning cull)."""
        n, u, v = self.basis()
        pix_w, pix_h = self.pixel_pitch()

        def fp(x):   # filled on the device: no host copy in the frame
            return torch.full((), x, dtype=self.pos.dtype,
                              device=self.pos.device)
        return Projection(origin=self.pos, n=n, u=u, v=v,
                          sx=self.focal / pix_w, sy=self.focal / pix_h,
                          adjust_x=fp(_adjust(self.res_w)),
                          adjust_y=fp(_adjust(self.res_h)))

    def ray_directions(self) -> torch.Tensor:
        """All primary ray directions, flat (H*W, 3), row iy = 0 = bottom;
        pixel i is (ix, iy) = (i % W, i // W) (Camera.cu:94-95)."""
        n_mod, u_mod, v_mod = self.ray_mods()
        i = torch.arange(self.res_h * self.res_w, device=self.pos.device)
        ix = (i % self.res_w).to(self.pos.dtype)
        iy = (i // self.res_w).to(self.pos.dtype)
        dx = n_mod[0] + u_mod[0] * ix + v_mod[0] * iy
        dy = n_mod[1] + u_mod[1] * ix + v_mod[1] * iy
        dz = n_mod[2] + u_mod[2] * ix + v_mod[2] * iy
        inv = torch.rsqrt(dx * dx + dy * dy + dz * dz)
        return torch.stack([dx * inv, dy * inv, dz * inv], dim=-1)


@dataclasses.dataclass
class RayBuffers:
    """Per-pixel ray state, the reference's ``Camera::pixel_memory``
    (Camera.h:15-97, filled by Camera.cu:89-111)."""

    rmd: torch.Tensor        # (N, 3) unit ray directions
    inv_rmd: torch.Tensor    # (N, 3) 1 / rmd (Camera.cu:106)
    sign_rmd: torch.Tensor   # (N, 3) int32 sign bits (Camera.cu:107)
    dist: torch.Tensor       # (N,) hit distance, draw_distance at first
    rmi: torch.Tensor        # (N,) int32 hit triangle, -1 at first

    @classmethod
    def create(cls, camera: Camera, draw_distance: float = 400.0
               ) -> "RayBuffers":
        rmd = camera.ray_directions()
        n = rmd.shape[0]
        return cls(rmd=rmd, inv_rmd=1.0 / rmd,
                   sign_rmd=vecmath.sign_bits(rmd),
                   dist=torch.full((n,), draw_distance, dtype=rmd.dtype,
                                   device=rmd.device),
                   rmi=torch.full((n,), -1, dtype=torch.int32,
                                  device=rmd.device))


@dataclasses.dataclass
class ObjectFrame:
    """A frame's set-up in one object's frame (pose-on-the-ray,
    Trixel.cu:60-66): the camera's origin R^T (pos - t), the rays R^T d
    (None where the method reads none) and the Projection (None where the
    method reads none)."""

    origin: torch.Tensor
    rays: torch.Tensor | None
    proj: Projection | None


@dataclasses.dataclass
class FrameSetup:
    """What a frame (or a band of rows) derives from the camera's and the
    poses' leaves before its intersects: ``rmd`` (R, 3) unit rays (None
    where no caller reads them), the camera Projection (``row0`` set for a
    band; None where the method reads none) and one `ObjectFrame` a
    pose."""

    rmd: torch.Tensor | None
    proj: Projection | None
    objects: list[ObjectFrame]


@torch.no_grad()
def object_frames(poses, origin: torch.Tensor, rmd: torch.Tensor | None,
                  proj: Projection | None, method: str) -> list[ObjectFrame]:
    """Each pose's `ObjectFrame` of the rays ``rmd`` from ``origin``, without
    autograd (the intersects that read them are discrete): the rays and the
    Projection where ``method`` reads them (`METHODS`; no rays where
    ``rmd`` is None)."""
    facts = METHODS[method]
    return [ObjectFrame(
        origin=pose.inv_apply(origin),
        rays=(pose.inv_apply_vec(rmd)
              if facts.object_rays and rmd is not None else None),
        proj=(proj.transformed(pose)
              if proj is not None and facts.proj else None))
        for pose in poses]


def frame_setup_reference(camera: Camera, poses, method: str, row0: int = 0,
                          band_h: int | None = None,
                          rays: bool = True) -> FrameSetup:
    """The set-up of frame rows [row0, row0 + band_h) (the whole frame by
    default) for the intersect ``method``: `Camera.ray_directions` (sliced
    to the band; None without ``rays``, which a bin probe reads none of),
    `Camera.projection` (where ``method`` reads it, with ``row0``) and
    `object_frames`. Plain PyTorch, kernel K11's plain version; outside
    `set_up_frame` its rays and Projection carry autograd to the camera,
    the object frames none."""
    rmd = None
    if rays:
        w = camera.res_w
        rmd = camera.ray_directions()
        if row0 or band_h is not None:
            rmd = rmd[row0 * w:(row0 + (camera.res_h - row0 if band_h is None
                                        else band_h)) * w]
    proj = None
    if METHODS[method].proj:
        proj = dataclasses.replace(camera.projection(), row0=row0)
    return FrameSetup(rmd, proj, object_frames(poses, camera.pos, rmd, proj,
                                               method))


def _set_up(camera: Camera, poses, method: str, row0: int,
            band_h: int | None, rays: bool) -> FrameSetup:
    """`frame_setup_reference`'s `FrameSetup` without autograd, bit for
    bit: kernel K11 on CUDA tensors, the plain version on CPU tensors."""
    if camera.pos.device.type != "cuda":
        with torch.no_grad():
            return frame_setup_reference(camera, poses, method, row0, band_h,
                                         rays)
    poses, facts = list(poses), METHODS[method]
    rmd, consts, obj_rays = k11.frame_setup(
        [getattr(camera, f) for f in Camera.LEAVES],
        [p.quat for p in poses], [p.translation for p in poses],
        camera.res_w, camera.res_h, row0,
        camera.res_h - row0 if band_h is None else band_h,
        _adjust(camera.res_w), _adjust(camera.res_h), rays,
        rays and facts.object_rays)
    proj = None
    if facts.proj:
        proj = Projection(origin=consts[0:3], n=consts[3:6], u=consts[6:9],
                          v=consts[9:12], sx=consts[12], sy=consts[13],
                          adjust_x=consts[14], adjust_y=consts[15], row0=row0)
    objects = []
    for i, r in enumerate(obj_rays):
        c = consts[FRAME_CONSTS + OBJ_CONSTS * i:][:OBJ_CONSTS]
        objects.append(ObjectFrame(
            origin=c[0:3], rays=r,
            proj=None if proj is None else dataclasses.replace(
                proj, origin=c[0:3], n=c[3:6], u=c[6:9], v=c[9:12])))
    return FrameSetup(rmd, proj, objects)


class _FrameSetupGrad(torch.autograd.Function):
    """`_set_up` differentiable in the camera's six leaves through its rays
    alone: forward K11 (the plain version on CPU tensors), backward K13
    (its plain twin `frame_setup_grad_reference` on CPU tensors). The rest
    of the `FrameSetup` (the Projection, the object frames, made without
    autograd) leaves as a second output that is no tensor, so autograd
    differentiates none of it; the poses go in as plain arguments."""

    @staticmethod
    def forward(ctx, camera, poses, method, row0, band_h, *leaves):
        ctx.set_materialize_grads(False)
        setup = _set_up(camera, poses, method, row0, band_h, True)
        ctx.frame = (camera.res_w, camera.res_h, row0)
        ctx.save_for_backward(*leaves)
        return setup.rmd, setup

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_rmd, _g_setup):
        lead = (None,) * 5
        need = ctx.needs_input_grad[5:]
        if g_rmd is None:
            return lead + (None,) * len(need)
        res_w, res_h, row0 = ctx.frame
        grad = (k11.frame_setup_grad if g_rmd.device.type == "cuda"
                else frame_setup_grad_reference)
        return lead + tuple(grad(ctx.saved_tensors, g_rmd, res_w, res_h,
                                 row0, _adjust(res_w), _adjust(res_h),
                                 need))


def set_up_frame(camera: Camera, poses, method: str, row0: int = 0,
                 band_h: int | None = None, rays: bool = True) -> FrameSetup:
    """`frame_setup_reference`'s `FrameSetup`, bit for bit: kernel K11 on
    CUDA tensors, the plain version on CPU tensors. Where autograd needs the
    rays (grad mode on, a camera leaf that requires grad, ``rays``) the same
    forward runs in `_FrameSetupGrad`, whose rays carry the camera's
    gradient (kernel K13 on CUDA tensors, `frame_setup_grad_reference` on
    CPU tensors); the Projection and the object frames never carry
    autograd. One K11 launch a call up to ``ops/cuda/shade.py``
    `max_objects` poses, one K13 call a backward."""
    if rays and torch.is_grad_enabled() and any(
            t.requires_grad for t in camera.parameters()):
        rmd, setup = _FrameSetupGrad.apply(
            camera, list(poses), method, row0, band_h,
            *(getattr(camera, f) for f in Camera.LEAVES))
        return dataclasses.replace(setup, rmd=rmd)
    return _set_up(camera, poses, method, row0, band_h, rays)
