"""The training set-up's backward: kernel K13's plain twin.

``models/camera.py`` `set_up_frame` takes an autograd Function where a
camera leaf needs autograd (the training steps): kernel K11 forward (its
plain version `frame_setup_reference` on CPU tensors), and for the
backward kernel K13 (``ops/cuda/shade.py`` `frame_setup_grad`) on CUDA
tensors or `frame_setup_grad_reference` here on CPU tensors, in place of
some 560 autograd nodes a step. Only the rays carry the camera's gradient:
the Projection and the object frames are read without autograd (the
intersects are discrete).

The twin recomputes what K11 computes and takes the rays' cotangent back
to the six camera leaves in K13's order: every product and sum its own
rounding, dots summed as (x + y) + z, the forward's normalising sums as
(x0 + x2) + x1 (K11's, the order of a (3,) ``torch.sum`` on the card),
``rsqrt``'s gradient -x^3 / 2 as x x x, the pixel pitch as the film times
the reciprocal of the resolution. Like K13 it sums the rays' nine partial
columns with one ``torch.sum``, so a step repeats bitwise.
"""

from __future__ import annotations

import torch

from .shade_grad import _cross, _dot


def _sq3(a):
    """K11's (3,) sum of squares: (a0 a0 + a2 a2) + a1 a1."""
    return (a[0] * a[0] + a[2] * a[2]) + a[1] * a[1]


def _unit_grad(a, inv, g):
    """The VJP of a rsqrt(|a|^2), inv = rsqrt(|a|^2), for the cotangent g:
    g inv + 2 (-1/2 (g . a) inv^3) a."""
    two = 2.0 * ((-0.5 * _dot(g, a)) * ((inv * inv) * inv))
    return [g[k] * inv + two * a[k] for k in range(3)]


def _plus(acc, x):
    return [acc[k] + x[k] for k in range(3)]


def frame_setup_grad_reference(camera_leaves, g_rmd: torch.Tensor,
                               res_w: int, res_h: int, row0: int,
                               adjust_x: float, adjust_y: float,
                               need) -> list:
    """Kernel K13's plain twin: the gradients of the six camera leaves
    (pos, look_at, up, film_w, film_h, focal) from the cotangent ``g_rmd``
    (band_h * res_w, 3) of the unit rays of frame rows [row0, row0 +
    band_h); ``adjust_x``, ``adjust_y``: the pixel-centre offsets.
    ``need``: six flags; returns six tensors, None where a flag is off."""
    pos, look, up, film_w, film_h, focal = (
        x.detach() for x in camera_leaves)
    dt, dev = pos.dtype, pos.device
    g = g_rmd.detach().to(dt).unbind(1)
    num_r = g_rmd.shape[0]

    # the forward, as K11 computes it
    a = [look[k] - pos[k] for k in range(3)]
    inv_a, inv_up = torch.rsqrt(_sq3(a)), torch.rsqrt(_sq3(up))
    n = [a[k] * inv_a for k in range(3)]
    upn = [up[k] * inv_up for k in range(3)]
    cu = _cross(upn, n)
    e = _cross(n, cu)
    inv_e = torch.rsqrt(_sq3(e))
    v = [e[k] * inv_e for k in range(3)]
    u = _cross(v, n)

    def recip(res):     # 1 / res rounded in the camera's dtype
        return torch.full((), res, dtype=dt, device=dev).reciprocal()
    rw, rh = recip(res_w), recip(res_h)
    pix_w, pix_h = film_w * rw, film_h * rh
    um = [u[k] * pix_w for k in range(3)]
    vm = [v[k] * pix_h for k in range(3)]
    nm = [(n[k] * focal - vm[k] * adjust_y) - um[k] * adjust_x
          for k in range(3)]

    # the rays: d = n_mod + u_mod ix + v_mod iy at the frame's pixel, its
    # normalise's VJP, and K13's nine partials a ray
    i = torch.arange(row0 * res_w, row0 * res_w + num_r, device=dev)
    ix, iy = (i % res_w).to(dt), (i // res_w).to(dt)
    d = [(nm[k] + um[k] * ix) + vm[k] * iy for k in range(3)]
    inv = torch.rsqrt((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2])
    g_d = _unit_grad(d, inv, g)
    partials = torch.stack([*g_d, *(ix * x for x in g_d),
                            *(iy * x for x in g_d)])
    sums = partials.sum(dim=1)

    # the chain to the leaves, as K13's chain launch takes it
    s0 = sums[0:3]
    g_um = [sums[3 + k] - s0[k] * adjust_x for k in range(3)]
    g_vm = [sums[6 + k] - s0[k] * adjust_y for k in range(3)]
    g_n = [s0[k] * focal for k in range(3)]
    g_u = [g_um[k] * pix_w for k in range(3)]
    g_v = [g_vm[k] * pix_h for k in range(3)]
    g_focal = _dot(s0, n)
    g_film_w = _dot(g_um, u) * rw
    g_film_h = _dot(g_vm, v) * rh
    g_v = _plus(g_v, _cross(n, g_u))             # u = v x n
    g_n = _plus(g_n, _cross(g_u, v))
    g_e = _unit_grad(e, inv_e, g_v)              # v = normalize(e)
    g_n = _plus(g_n, _cross(cu, g_e))            # e = n x cu
    g_cu = _cross(g_e, n)
    g_upn = _cross(n, g_cu)                      # cu = upn x n
    g_n = _plus(g_n, _cross(g_cu, upn))
    g_up = _unit_grad(up, inv_up, g_upn)
    g_a = _unit_grad(a, inv_a, g_n)              # n = normalize(look - pos)
    grads = (torch.stack([-x for x in g_a]), torch.stack(g_a),
             torch.stack(g_up), g_film_w, g_film_h, g_focal)
    return [x if on else None for x, on in zip(grads, need)]
