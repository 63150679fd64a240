"""Phong shading, tone mapping and framebuffer composition (the JAX
package's ``ops/shade.py``; reference color_cam_cuda, Camera.cu:19-69):

  L        = normalize(light_pos - hit_point)
  dot_r_n  = L . N
  r        = (L - 2 dot_r_n N) * ray_dir      (componentwise product)
  diffuse  = kd * |dot_r_n|
  spec     = ks * |sum(r)| ** exponent
  rgb      = tri_color * diffuse * light_color + light_color * spec
  tonemap: rgb / max(rgb) * 255 per pixel, rounded
"""

from __future__ import annotations

import torch

from . import vecmath


def phong_radiance(hit_point: torch.Tensor, normal: torch.Tensor,
                   ray_dir: torch.Tensor, tri_color: torch.Tensor,
                   params) -> torch.Tensor:
    """Per-pixel Phong radiance (R, 3) from world-space (R, 3) inputs; the
    (R, 3) form of `phong_radiance_c`."""
    l = vecmath.normalize(params.light_pos[None, :] - hit_point)
    dot_r_n = vecmath.dot(l, normal)
    r = (l - 2.0 * dot_r_n[..., None] * normal) * ray_dir
    diffuse = params.diffuse * dot_r_n.abs()
    spec = params.specular * r.sum(dim=-1).abs() ** params.exponent
    return (tri_color * diffuse[..., None] * params.light_color[None, :]
            + params.light_color[None, :] * spec[..., None])


def phong_radiance_c(hit_point, normal, ray_dir, tri_color, params):
    """Phong radiance on (x, y, z)-tuples of flat (R,) tensors; returns the
    flat (r, g, b) tuple. Differentiable in every input and parameter."""
    px, py, pz = hit_point
    nx, ny, nz = normal
    dx, dy, dz = ray_dir
    cr, cg, cb = tri_color
    lx = params.light_pos[0] - px
    ly = params.light_pos[1] - py
    lz = params.light_pos[2] - pz
    inv_len = torch.rsqrt(lx * lx + ly * ly + lz * lz)
    lx, ly, lz = lx * inv_len, ly * inv_len, lz * inv_len
    dot_r_n = lx * nx + ly * ny + lz * nz
    rsum = ((lx - 2.0 * dot_r_n * nx) * dx
            + (ly - 2.0 * dot_r_n * ny) * dy
            + (lz - 2.0 * dot_r_n * nz) * dz)
    diffuse = params.diffuse * dot_r_n.abs()
    spec = params.specular * rsum.abs() ** params.exponent
    lc = params.light_color
    return (cr * diffuse * lc[0] + lc[0] * spec,
            cg * diffuse * lc[1] + lc[1] * spec,
            cb * diffuse * lc[2] + lc[2] * spec)


def tonemap_maxnorm(radiance: torch.Tensor) -> torch.Tensor:
    """Per-pixel max-channel normalise to [0, 1]; zero pixels stay zero."""
    peak = radiance.amax(dim=-1, keepdim=True)
    return radiance / torch.where(peak > 0, peak, 1.0)


def compose_framebuffer(radiance: torch.Tensor, hit_mask: torch.Tensor,
                        background_rgb) -> torch.Tensor:
    """uint8 (R, 3) image: tonemapped hits over the background fill.

    Rounds rather than truncates, so the peak channel is 255 (Camera.cu:
    56-59); ``torch.round`` is half-to-even like ``jnp.round``."""
    shaded = torch.clamp(torch.round(tonemap_maxnorm(radiance) * 255.0),
                         0.0, 255.0)
    # filled on the device: no host copy in the frame (a captured frame
    # may not make one)
    bg = torch.stack([torch.full((), float(c), dtype=radiance.dtype,
                                 device=radiance.device)
                      for c in background_rgb])
    return torch.where(hit_mask[..., None], shaded, bg).to(torch.uint8)


def pack_bgra(rgb_u8: torch.Tensor) -> torch.Tensor:
    """(R, 3) uint8 -> (R,) uint32 packed BGRA (reference Color.h:4-13)."""
    c = rgb_u8.to(torch.int64)
    return (c[..., 2] | (c[..., 1] << 8) | (c[..., 0] << 16)).to(torch.uint32)
