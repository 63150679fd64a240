"""Unit quaternions and rigid poses (the JAX package's ``ops/quaternion.py``).

Quaternion layout is ``(x, y, z, w)``. The 3x3 products below are float32
matmuls: PyTorch keeps them in full float32 on the GPU as long as
``torch.backends.cuda.matmul.allow_tf32`` stays False (its default), which
is what the JAX package's ``Precision.HIGHEST`` einsums ask for.
"""

from __future__ import annotations

import torch
from torch import nn

from . import vecmath


def identity(*, device, dtype=torch.float32) -> torch.Tensor:
    return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=device)


def qmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a ⊗ b (reference vector.cpp:40-45)."""
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack((
        ay * bz - az * by + ax * bw + aw * bx,
        az * bx - ax * bz + ay * bw + aw * by,
        ax * by - ay * bx + az * bw + aw * bz,
        aw * bw - ax * bx - ay * by - az * bz,
    ), dim=-1)


def qconj(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([-1.0, -1.0, -1.0, 1.0], dtype=q.dtype,
                            device=q.device)


def qnormalize(q: torch.Tensor) -> torch.Tensor:
    return q * torch.rsqrt((q * q).sum(dim=-1, keepdim=True))


def to_matrix(q: torch.Tensor) -> torch.Tensor:
    """3x3 rotation matrix of unit quaternion ``q`` (..., 4)."""
    x, y, z, w = q.unbind(-1)
    r = torch.stack((
        1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w,
        2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w,
        2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y,
    ), dim=-1)
    return r.reshape(*q.shape[:-1], 3, 3)


def from_axis_angle(axis, angle: float, *, device) -> torch.Tensor:
    """Unit quaternion for a rotation of ``angle`` radians about ``axis``."""
    axis = vecmath.normalize(torch.as_tensor(axis, dtype=torch.float32,
                                             device=device))
    half = torch.as_tensor(angle, dtype=torch.float32, device=device) / 2.0
    return torch.cat([axis * torch.sin(half), torch.cos(half).reshape(1)])


def rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors ``v`` (..., 3) by unit quaternion ``q``: R v."""
    return v @ to_matrix(q).T


def inverse_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate by the conjugate: R^T v (rays into the object frame)."""
    return v @ to_matrix(q)


class Pose(nn.Module):
    """Rigid pose: rotation quaternion + translation (object -> world)."""

    def __init__(self, quat: torch.Tensor, translation: torch.Tensor):
        super().__init__()
        self.quat = nn.Parameter(quat)                # (4,) unit (x, y, z, w)
        self.translation = nn.Parameter(translation)  # (3,)

    @classmethod
    def identity(cls, *, device) -> "Pose":
        return cls(identity(device=device), torch.zeros(3, device=device))

    def matrix(self) -> torch.Tensor:
        return to_matrix(self.quat)

    def apply(self, pts: torch.Tensor) -> torch.Tensor:
        """Object frame -> world: R p + t."""
        return rotate(self.quat, pts) + self.translation

    def apply_vec(self, v: torch.Tensor) -> torch.Tensor:
        """Rotate direction vectors (no translation)."""
        return rotate(self.quat, v)

    def inv_apply(self, pts: torch.Tensor) -> torch.Tensor:
        """World -> object frame: R^T (p - t)."""
        return inverse_rotate(self.quat, pts - self.translation)

    def inv_apply_vec(self, v: torch.Tensor) -> torch.Tensor:
        return inverse_rotate(self.quat, v)

    @torch.no_grad()
    def translated(self, delta: torch.Tensor) -> "Pose":
        """A new pose moved by ``delta`` in world space; geometry never
        moves (reference Camera.cu:188-192,271-279)."""
        return Pose(self.quat.clone(), self.translation + delta)

    @torch.no_grad()
    def rotated(self, dq: torch.Tensor, pivot: torch.Tensor | None = None
                ) -> "Pose":
        """A new pose with rotation ``dq`` composed on the right, about the
        world-space ``pivot`` (default the pose origin), as the reference's
        recentring rotation keys do (Camera.cu:288-329)."""
        new_q = qnormalize(qmul(self.quat, dq))
        if pivot is None:
            return Pose(new_q, self.translation.clone())
        # the pivot stays fixed: t' = pivot + (R' R^-1)(t - pivot)
        spin = qmul(new_q, qconj(self.quat))
        return Pose(new_q, pivot + rotate(spin, self.translation - pivot))
