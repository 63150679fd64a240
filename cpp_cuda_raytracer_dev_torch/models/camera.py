"""Pinhole camera and primary-ray generation (the JAX package's
``models/camera.py``).

Conventions (reference Camera.cpp:32-67):
  n = normalize(look_at - pos), v = normalize(n x (up x n)), u = v x n
  pixel pitch = film / resolution
  ray(ix, iy) = normalize(n*focal + u_mod*(ix - adjust_x)
                          + v_mod*(iy - adjust_y))
with adjust = res // 2, minus half a pixel when the resolution is even.
Row iy = 0 is the bottom of the image.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..ops import vecmath


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
