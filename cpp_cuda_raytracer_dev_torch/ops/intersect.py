"""Möller–Trumbore oracles (the JAX package's ``ops/intersect.py``).

- `mt_brute`: every ray against every triangle, the ground-truth oracle.
- `FixedOriginCache` + `mt_fixed_origin`: rays that share one origin reduce
  the MT determinants to three (R, 3) @ (3, T) products against constant
  per-triangle vectors (the reference's camera-space cache d_t/d_q/d_w,
  Trixel.cu:29-36).

Acceptance matches the reference (Trixel.cu:106,127): reject when
|det| < eps, u < eps, v < eps, u+v > 1+eps, t < eps, or t >= the current
best. Tie rule: at an exactly equal t the lowest triangle id wins.

Both oracles chunk over triangles (running best carried, strictly smaller t
replaces it) and over rays, so memory stays at about ``_PAIRS`` pairs.
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils.dtypes import DEFAULT_DRAW_DISTANCE, MT_EPSILON
from . import vecmath

_PAIRS = 1 << 24        # ray-triangle pairs per chunk step
_NO_TRI = torch.iinfo(torch.int32).max


@dataclasses.dataclass
class Hit:
    """Per-ray nearest hit: distance, triangle id, object id (-1 on miss)."""

    t: torch.Tensor      # (R,) the rays' float dtype, draw_distance on a miss
    tri: torch.Tensor    # (R,) int32
    obj: torch.Tensor    # (R,) int32

    @classmethod
    def miss(cls, num_rays: int,
             draw_distance: float = DEFAULT_DRAW_DISTANCE, *, device,
             dtype=torch.float32) -> "Hit":
        return cls(
            t=torch.full((num_rays,), draw_distance, dtype=dtype,
                         device=device),
            tri=torch.full((num_rays,), -1, dtype=torch.int32, device=device),
            obj=torch.full((num_rays,), -1, dtype=torch.int32, device=device))

    def merge(self, other: "Hit") -> "Hit":
        """Nearest-hit combine; ``other`` wins only on a strictly smaller t."""
        take = other.t < self.t
        return Hit(t=torch.where(take, other.t, self.t),
                   tri=torch.where(take, other.tri, self.tri),
                   obj=torch.where(take, other.obj, self.obj))


def mt_test(o, d, p1, e1, e2, eps: float = MT_EPSILON):
    """Elementwise MT with broadcasting over (..., 3) operands.

    Returns (t, u, v, valid); t is +inf where invalid."""
    pvec = vecmath.cross(d, e2)
    det = vecmath.dot(e1, pvec)
    tvec = o - p1
    qvec = vecmath.cross(tvec, e1)
    inv = torch.reciprocal(torch.where(det == 0.0, 1.0, det))
    u = inv * vecmath.dot(tvec, pvec)
    v = inv * vecmath.dot(d, qvec)
    t = inv * vecmath.dot(e2, qvec)
    valid = ((det.abs() >= eps) & (u >= eps) & (v >= eps)
             & (u + v <= 1.0 + eps) & (t >= eps))
    return torch.where(valid, t, torch.inf), u, v, valid


def _nearest(t: torch.Tensor, base: int, best: Hit, r0: int, r1: int):
    """Fold a (rays, chunk) block of t into ``best[r0:r1]``: the block's
    minimum, lowest id at that minimum, replaces on a strictly smaller t."""
    tmin = t.amin(dim=1)
    ids = torch.arange(base, base + t.shape[1], dtype=torch.int32,
                       device=t.device)
    amin = torch.where(t == tmin[:, None], ids, _NO_TRI).amin(dim=1)
    cur_t, cur_tri = best.t[r0:r1], best.tri[r0:r1]
    better = tmin < cur_t
    best.t[r0:r1] = torch.where(better, tmin, cur_t)
    best.tri[r0:r1] = torch.where(better, amin, cur_tri)


def mt_brute(o: torch.Tensor, d: torch.Tensor, tris,
             draw_distance: float = DEFAULT_DRAW_DISTANCE,
             eps: float = MT_EPSILON, chunk: int = 4096) -> Hit:
    """Every ray (R, 3) from origin ``o`` (3,) vs every triangle; the
    nearest valid hit below draw_distance."""
    p1, e1, e2 = tris.p1, tris.e1, tris.e2
    best = Hit.miss(d.shape[0], draw_distance, device=d.device,
                    dtype=d.dtype)
    rstep = max(1, _PAIRS // chunk)
    for c0 in range(0, p1.shape[0], chunk):
        sl = slice(c0, c0 + chunk)
        for r0 in range(0, d.shape[0], rstep):
            r1 = min(r0 + rstep, d.shape[0])
            t, _, _, _ = mt_test(o, d[r0:r1, None, :], p1[None, sl],
                                 e1[None, sl], e2[None, sl], eps)
            _nearest(t, c0, best, r0, r1)
    return best


@dataclasses.dataclass
class FixedOriginCache:
    """Per-(origin, object) triangle constants for the matmul-form MT."""

    m_det: torch.Tensor   # (T, 3) = cross(e2, e1)
    m_u: torch.Tensor     # (T, 3) = cross(e2, o - p1)
    m_v: torch.Tensor     # (T, 3) = cross(o - p1, e1)  (reference d_q)
    tdet: torch.Tensor    # (T,)   = dot(e2, m_v)        (reference d_w)

    @classmethod
    def build(cls, origin: torch.Tensor, tris) -> "FixedOriginCache":
        tvec = origin[None, :] - tris.p1
        m_v = vecmath.cross(tvec, tris.e1)
        return cls(m_det=vecmath.cross(tris.e2, tris.e1),
                   m_u=vecmath.cross(tris.e2, tvec), m_v=m_v,
                   tdet=vecmath.dot(tris.e2, m_v))


def mt_fixed_origin(d: torch.Tensor, cache: FixedOriginCache,
                    draw_distance: float = DEFAULT_DRAW_DISTANCE,
                    eps: float = MT_EPSILON, chunk: int = 2048) -> Hit:
    """Nearest hit for unit rays ``d`` (R, 3) sharing the cache's origin."""
    best = Hit.miss(d.shape[0], draw_distance, device=d.device,
                    dtype=d.dtype)
    rstep = max(1, _PAIRS // chunk)
    for c0 in range(0, cache.tdet.shape[0], chunk):
        sl = slice(c0, c0 + chunk)
        mdt, mut, mvt = cache.m_det[sl].T, cache.m_u[sl].T, cache.m_v[sl].T
        tdc = cache.tdet[sl]
        for r0 in range(0, d.shape[0], rstep):
            r1 = min(r0 + rstep, d.shape[0])
            dc = d[r0:r1]
            det = dc @ mdt
            inv = torch.reciprocal(torch.where(det == 0.0, 1.0, det))
            u = (dc @ mut) * inv
            v = (dc @ mvt) * inv
            t = tdc[None, :] * inv
            valid = ((det.abs() >= eps) & (u >= eps) & (v >= eps)
                     & (u + v <= 1.0 + eps) & (t >= eps))
            _nearest(torch.where(valid, t, torch.inf), c0, best, r0, r1)
    return best
