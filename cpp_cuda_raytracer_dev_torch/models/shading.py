"""Shading and composition of given hits: the plain, differentiable
`shade_compose_reference`, and `shade_compose`, the one choice of device
between it and kernel K10 (``ops/cuda/shade.py``), for the serving frames
and the forward of ``models/shade_grad.py``'s autograd Function.
"""

from __future__ import annotations

import torch

from ..ops.cuda import shade as k10
from ..ops.gather import gather_rows, sums_by_k2, take_rows
from ..ops.intersect import Hit
from ..ops.shade import compose_framebuffer, phong_radiance_c
from ..utils.config import RenderConfig
from .scene import Scene


def shade_hits(scene: Scene, origin: torch.Tensor, rmd: torch.Tensor,
               hit: Hit, config: RenderConfig):
    """Differentiable shading given the hit indices.

    Returns (radiance (R,3), normal (R,3), point (R,3), hit_mask (R,))."""
    num_r = rmd.shape[0]
    tri_idx = torch.clamp_min(hit.tri, 0)
    gather = (gather_rows if sums_by_k2(config.sorted_scatter, rmd.dtype)
              else take_rows)
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


def shade_compose_reference(scene: Scene, origin: torch.Tensor,
                            rmd: torch.Tensor, hit: Hit,
                            config: RenderConfig) -> dict:
    """`shade_hits` and `compose_framebuffer`: the plain, differentiable
    version of `shade_and_compose` (kernel K10's plain twin,
    ``ops/cuda/shade.py``, and the autograd reference of K12's twin,
    ``models/shade_grad.py``)."""
    radiance, normal, point, hit_mask = shade_hits(scene, origin, rmd, hit,
                                                   config)
    image = compose_framebuffer(radiance, hit_mask, config.background_rgb)
    return dict(image=image,
                radiance=torch.where(hit_mask[..., None], radiance, 0.0),
                hit_t=hit.t, hit_tri=hit.tri, hit_obj=hit.obj,
                normal=normal, point=point)


def shade_compose(scene, origin: torch.Tensor, rmd: torch.Tensor, hit: Hit,
                  config) -> dict:
    """`shade_compose_reference`'s outputs, bit for bit: kernel K10 on CUDA
    tensors, the plain version on CPU tensors."""
    if rmd.device.type == "cuda":
        return k10.shade_compose(scene, origin, rmd, hit, config)
    return shade_compose_reference(scene, origin, rmd, hit, config)
