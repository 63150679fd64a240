"""The plain reference over several posed objects: the reference renderer's
scene of several ``Object``s, each with its own quaternion pose, over one
list of triangles or several (its WinMain.cpp:152-156, Object.h:4-17).

Each object is intersected as `render.nearest_hits` intersects one: the
rays move into the object's frame (the pose on the ray, Trixel.cu:60-66)
and its nearest hit is found there. The objects' hits are then combined
in order, a later object winning only on a strictly smaller t, and each
pixel is shaded by its object with that object's pose. Plain PyTorch in
float32 with TF32 off, on `render`'s functions; it imports nothing of the
program under test.

Inputs are `render`'s dicts, with ``poses`` a list of pose dicts, one an
object, and ``tris`` one triangle dict that every object shares or a list
of them, one an object. Outputs are flat per pixel, as `render`'s, with
``obj`` (the object hit, -1 on a miss) beside ``tri`` (its triangle).
"""

from __future__ import annotations

import torch

from . import render


def _per_object(tris, poses: list) -> list:
    return list(tris) if isinstance(tris, (list, tuple)) else [tris] * len(
        poses)


@torch.no_grad()
def nearest_hits(tris, poses: list, camera: dict, cull: bool,
                 d: torch.Tensor | None = None):
    """(t (R,), tri (R,) int64, obj (R,) int64): each pixel's nearest hit
    over the objects, -1 and `render.DRAW_DISTANCE` on a miss. Each object's
    own nearest hit is `render.nearest_hits`'s; object k replaces the hit
    of the objects before it only where its t is strictly smaller."""
    if d is None:
        d = render.rays(camera)
    best_t = best_tri = best_obj = None
    for k, (tr, pose) in enumerate(zip(_per_object(tris, poses), poses)):
        t, tri = render.nearest_hits(tr, pose, camera, cull, d)
        if best_t is None:
            best_t, best_tri = t, tri
            best_obj = torch.where(tri >= 0, k, -1)
            continue
        take = t < best_t
        best_t = torch.where(take, t, best_t)
        best_tri = torch.where(take, tri, best_tri)
        best_obj = torch.where(take, k, best_obj)
    return best_t, best_tri, best_obj


def _own(tri: torch.Tensor, obj: torch.Tensor, k: int) -> torch.Tensor:
    """The choice of triangle where object ``k`` is chosen, a miss
    elsewhere."""
    return torch.where(obj == k, tri, -1)


@torch.no_grad()
def choice(tris, poses: list, camera: dict, phong: dict,
           hit_obj: torch.Tensor, hit_tri: torch.Tensor,
           d: torch.Tensor | None = None) -> dict:
    """This reference's frame of a given choice of (object, triangle) at
    each pixel: `render.choice`'s ``t``, ``margin``, ``cos``, ``radiance``
    and ``image`` of each pixel's chosen triangle in its object's frame,
    shaded with its object's pose, and the choice itself (``tri``,
    ``obj``)."""
    if d is None:
        d = render.rays(camera)
    hit_obj, hit_tri = hit_obj.long(), hit_tri.long()
    out = None
    for k, (tr, pose) in enumerate(zip(_per_object(tris, poses), poses)):
        mine = render.choice(tr, pose, camera, phong,
                             _own(hit_tri, hit_obj, k), d)
        if out is None:
            out = mine
            continue
        at = hit_obj == k
        out = {f: torch.where(at.reshape(-1, *[1] * (v.dim() - 1)),
                              mine[f], v) for f, v in out.items()}
    out["tri"] = torch.where(hit_obj >= 0, hit_tri, -1)
    out["obj"] = torch.where(hit_obj >= 0, hit_obj, -1)
    return out


@torch.no_grad()
def render_objects(tris, poses: list, camera: dict, phong: dict, cull: bool,
                   precision: str = "float32") -> dict:
    """One frame of the objects: the nearest hits and `choice`'s frame of
    them (flat ``t``, ``tri``, ``obj``, ``margin``, ``cos``, ``radiance``,
    ``image``). ``precision`` "tf32" is the control: every input rounded
    by `render.tf32`."""
    if precision == "tf32":
        tris = ([render.rounded(x) for x in tris]
                if isinstance(tris, (list, tuple)) else render.rounded(tris))
        poses = [render.rounded(p) for p in poses]
        camera, phong = render.rounded(camera), render.rounded(phong)
    elif precision != "float32":
        raise ValueError(f"unknown precision {precision!r}")
    d = render.rays(camera)
    t, tri, obj = nearest_hits(tris, poses, camera, cull, d)
    return dict(choice(tris, poses, camera, phong, obj, tri, d), t=t)


def radiance(tris, poses: list, camera: dict, phong: dict,
             hit_obj: torch.Tensor, hit_tri: torch.Tensor, hit_t: torch.Tensor,
             d: torch.Tensor) -> torch.Tensor:
    """Phong radiance (R, 3) of each pixel's chosen (object, triangle), 0
    on a miss: `render.shade` of each object's pixels with its pose,
    differentiable in every float input (a triangle list that several
    objects share gets the sum of their gradients)."""
    out = 0.0
    for k, (tr, pose) in enumerate(zip(_per_object(tris, poses), poses)):
        out = out + render.shade(tr, pose, camera, phong, hit_t,
                                 _own(hit_tri, hit_obj, k), d)
    return out


def loss(tris, poses: list, camera: dict, phong: dict, cull: bool,
         target: torch.Tensor) -> torch.Tensor:
    """The fitting loss mean((radiance - target) ** 2) of the objects'
    frame over every pixel and channel; ``target`` (R, 3). Differentiable
    in the float inputs."""
    d = render.rays(camera)
    t, tri, obj = nearest_hits(tris, poses, camera, cull, d.detach())
    rad = radiance(tris, poses, camera, phong, obj, tri, t, d)
    return torch.mean((rad - target) ** 2)
