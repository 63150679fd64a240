"""Vector math over ``(..., 3)`` tensors (the JAX package's
``ops/vecmath.py``)."""

from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3D dot product -> (...,)."""
    return (a * b).sum(dim=-1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3D cross product (ay*bz-az*by, az*bx-ax*bz, ax*by-ay*bx)."""
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack((ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx), dim=-1)


def normalize(a: torch.Tensor) -> torch.Tensor:
    """Unit vector along ``a``."""
    return a * torch.rsqrt(dot(a, a)).unsqueeze(-1)


def norm(a: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis."""
    return torch.sqrt(dot(a, a))


def normalize_with_invnorm(a: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(unit vector, inverse norm); the reference's ``normalize_Vector``
    keeps 1/|v| in the ``w`` slot (Vector.h:253-261)."""
    inv = torch.rsqrt(dot(a, a))
    return a * inv.unsqueeze(-1), inv


def quake_rsqrt(s: torch.Tensor, newton_iters: int = 8) -> torch.Tensor:
    """The reference's bit-trick inverse square root (vector.cpp:13-26):
    the magic constant 0x5f375a86, then ``newton_iters`` Newton steps, in
    float32. Kept for parity checks; the renderer uses ``torch.rsqrt``."""
    s = torch.as_tensor(s, dtype=torch.float32)
    half = 0.5 * s
    x = (0x5F375A86 - (half.view(torch.int32) >> 1)).view(torch.float32)
    for _ in range(newton_iters):
        x = x * (1.5 - half * x * x)
    return x


def reflect(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """``v`` reflected about the unit normal ``n``: v - 2 (v.n) n
    (inline in the Phong kernel, Camera.cu:39-41)."""
    return v - 2.0 * dot(v, n).unsqueeze(-1) * n


def sign_bits(a: torch.Tensor) -> torch.Tensor:
    """int32 1 where a component is negative, else 0 (``sign_rmd``,
    Camera.cu:107)."""
    return (a < 0).to(torch.int32)
