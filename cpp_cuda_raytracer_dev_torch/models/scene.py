"""Scene data model as ``nn.Module``s (the JAX package's ``models/scene.py``).

The parameters keep the JAX package's flat-leaf layout: nine (T,) leaves
``p1x … e2z`` plus a (T, 3) ``color``. Module attribute names follow the
JAX pytree paths, so ``Scene.state_dict()`` keys (``objects.0.tris.p1x``,
``phong.light_pos``, ...) are the JAX leaves' paths (utils/convert.py).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops.quaternion import Pose

TRI_FIELDS = ("p1x", "p1y", "p1z", "e1x", "e1y", "e1z", "e2x", "e2y", "e2z")
DEFAULT_COLOR = (0.1, 0.55, 0.20)   # reference scene, WinMain.cpp:118-120


class Triangles(nn.Module):
    """Triangle soup: first vertex p1, edges e1 = p2 - p1, e2 = p3 - p1."""

    def __init__(self, p1x, p1y, p1z, e1x, e1y, e1z, e2x, e2y, e2z, color):
        super().__init__()
        for name, value in zip(TRI_FIELDS, (p1x, p1y, p1z, e1x, e1y, e1z,
                                            e2x, e2y, e2z)):
            setattr(self, name, nn.Parameter(value))
        self.color = nn.Parameter(color)      # (T, 3) radiance rgb

    @classmethod
    def from_vertices(cls, tri_vertices, *, device, color=None,
                      dtype=torch.float32) -> "Triangles":
        """Build from (T, 3, 3) vertex blocks (reference init_tri_mem_cuda,
        Trixel.cu:11-27); the default colour is the reference scene's.
        ``dtype`` is the scene's precision (utils/dtypes.py `Precision`)."""
        tv = torch.as_tensor(tri_vertices, dtype=dtype, device=device)
        p1 = tv[:, 0]
        e1 = tv[:, 1] - p1
        e2 = tv[:, 2] - p1
        rgb = torch.as_tensor(DEFAULT_COLOR if color is None else color,
                              dtype=dtype, device=device)
        comps = [c.contiguous() for v in (p1, e1, e2) for c in v.unbind(1)]
        return cls(*comps, rgb.expand(p1.shape).contiguous())

    @property
    def p1(self) -> torch.Tensor:
        return torch.stack([self.p1x, self.p1y, self.p1z], dim=-1)

    @property
    def e1(self) -> torch.Tensor:
        return torch.stack([self.e1x, self.e1y, self.e1z], dim=-1)

    @property
    def e2(self) -> torch.Tensor:
        return torch.stack([self.e2x, self.e2y, self.e2z], dim=-1)

    @property
    def n(self) -> torch.Tensor:
        """(T, 3) unit geometric normals normalize(e1 x e2), derived (a
        zero-area triangle's is clamped, not NaN)."""
        cnx = self.e1y * self.e2z - self.e1z * self.e2y
        cny = self.e1z * self.e2x - self.e1x * self.e2z
        cnz = self.e1x * self.e2y - self.e1y * self.e2x
        inv = torch.rsqrt(torch.clamp_min(cnx * cnx + cny * cny + cnz * cnz,
                                          1e-30))
        return torch.stack([cnx * inv, cny * inv, cnz * inv], dim=-1)

    @property
    def num_triangles(self) -> int:
        return self.p1x.shape[0]

    def vertices(self) -> torch.Tensor:
        """Back to (T, 3, 3) vertex blocks (p1, p2, p3)."""
        p1 = self.p1
        return torch.stack([p1, p1 + self.e1, p1 + self.e2], dim=1)

    def aabbs(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-triangle (T, 3) AABB corners."""
        v = self.vertices()
        return v.amin(dim=1), v.amax(dim=1)

    def centroid(self) -> torch.Tensor:
        """Mid-point of the overall AABB, the reference's ``zero_offset``
        (Trixel.h:468-471): the pivot of the rotation keys."""
        lo, hi = self.aabbs()
        return (lo.amin(dim=0) + hi.amax(dim=0)) / 2.0


class SceneObject(nn.Module):
    """Geometry + pose; the pose moves rays, never the geometry."""

    def __init__(self, tris: Triangles, pose: Pose | None = None):
        super().__init__()
        self.tris = tris
        self.pose = (pose if pose is not None
                     else Pose.identity(device=tris.p1x.device,
                                        dtype=tris.p1x.dtype))


class PhongParams(nn.Module):
    """Phong/lighting parameters (kernel literals of Camera.cu:32,44-52)."""

    def __init__(self, light_pos, light_color, diffuse, specular, exponent):
        super().__init__()
        self.light_pos = nn.Parameter(light_pos)      # (3,)
        self.light_color = nn.Parameter(light_color)  # (3,)
        self.diffuse = nn.Parameter(diffuse)          # scalar
        self.specular = nn.Parameter(specular)        # scalar
        self.exponent = nn.Parameter(exponent)        # scalar

    @classmethod
    def reference(cls, *, device, dtype=torch.float32) -> "PhongParams":
        def fp(x):
            return torch.tensor(x, dtype=dtype, device=device)
        return cls(fp([2.0, 2.0, 2.0]), fp([1.0, 1.0, 1.0]), fp(0.6),
                   fp(0.3), fp(5.0))


class Scene(nn.Module):
    """A renderable scene: objects + lighting parameters."""

    def __init__(self, objects, phong: PhongParams | None = None):
        super().__init__()
        self.objects = nn.ModuleList(objects)
        if phong is None:
            p1x = self.objects[0].tris.p1x
            phong = PhongParams.reference(device=p1x.device, dtype=p1x.dtype)
        self.phong = phong


def default_colors(num_tri: int) -> np.ndarray:
    """(num_tri, 3) float32 per-triangle colours of the reference scene
    (WinMain.cpp:117-121)."""
    return np.broadcast_to(np.array(DEFAULT_COLOR, np.float32),
                           (num_tri, 3)).copy()
