"""The scene of a configuration, built once as plain leaf tensors (the
inputs both sides are handed) and then as the program's objects over the
same storage, so that an optimizer step of the program, or a pose written
into a leaf, is seen by both.

A configuration names its mesh generator (``meshes/<generator>.py``), its
acceleration structure's builder (``accels/<builder>.py``, or none), the
program's ``RenderConfig`` whole (``render``) and the kernel sources its
frame and step run (``kernel_sources``); nothing here is per
configuration."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import plugins

TRI_FIELDS = ("p1x", "p1y", "p1z", "e1x", "e1y", "e1z", "e2x", "e2y", "e2z")
CAMERA_FIELDS = ("pos", "look_at", "up", "film_w", "film_h", "focal")
PHONG_FIELDS = ("light_pos", "light_color", "diffuse", "specular",
                "exponent")


def vertices(config: dict) -> np.ndarray:
    """(T, 3, 3) float32 vertices of the configuration's mesh."""
    m = config["mesh"]
    tv = plugins.load("meshes", m["generator"]).vertices(m)
    if tv.shape[0] != m["expect_triangles"]:
        raise ValueError(f"{tv.shape[0]} triangles, the configuration "
                         f"states {m['expect_triangles']}")
    return tv


def camera_start(config: dict) -> np.ndarray:
    """The camera's position: ``pos`` where the configuration gives one,
    else ``distance`` from ``look_at`` along -z."""
    cam = config["camera"]
    if "pos" in cam:
        return np.asarray(cam["pos"], np.float64)
    return np.asarray(cam["look_at"], np.float64) + [0.0, 0.0,
                                                     -cam["distance"]]


def leaves(config: dict, tv: np.ndarray, dev) -> dict:
    """Every float input by its group and name: ``tris.p1x`` .. ``tris.e2z``
    (T,), ``tris.color`` (T, 3), ``pose.quat``, ``pose.translation``,
    ``phong.*`` and ``camera.*``; e1 = p2 - p1 and e2 = p3 - p1 in
    float32."""
    v = torch.as_tensor(tv, dtype=torch.float32, device=dev)
    p1, e1, e2 = v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
    out = {f"tris.{n}": c.contiguous() for n, c in
           zip(TRI_FIELDS, (*p1.unbind(1), *e1.unbind(1), *e2.unbind(1)))}
    out["tris.color"] = torch.tensor(config["color"], device=dev).expand(
        v.shape[0], 3).contiguous()
    out["pose.quat"] = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev)
    out["pose.translation"] = torch.zeros(3, device=dev)
    for k in PHONG_FIELDS:
        out[f"phong.{k}"] = torch.tensor(config["phong"][k], device=dev)
    cam = config["camera"]
    for k, x in (("pos", camera_start(config).tolist()),
                 ("look_at", cam["look_at"]), ("up", cam["up"]),
                 ("film_w", cam["film_h"] * cam["res_w"] / cam["res_h"]),
                 ("film_h", cam["film_h"]), ("focal", cam["focal"])):
        out[f"camera.{k}"] = torch.tensor(x, dtype=torch.float32, device=dev)
    return out


def reference_inputs(config: dict, lv: dict) -> tuple[dict, dict, dict, dict]:
    """(tris, pose, camera, phong) dicts of the reference renderer over the
    leaves ``lv`` (the geometry stacked, so gradients reach each leaf)."""
    cam = config["camera"]
    tris = {"geom": torch.stack([lv[f"tris.{n}"] for n in TRI_FIELDS], 1),
            "color": lv["tris.color"]}
    pose = {"quat": lv["pose.quat"], "translation": lv["pose.translation"]}
    camera = {k: lv[f"camera.{k}"] for k in CAMERA_FIELDS}
    camera.update(res_w=cam["res_w"], res_h=cam["res_h"])
    phong = {k: lv[f"phong.{k}"] for k in PHONG_FIELDS}
    return tris, pose, camera, phong


def cull(config: dict) -> bool:
    """Whether the configuration culls triangles facing away."""
    return bool(config["render"].get("backface_cull", False))


@dataclasses.dataclass
class Program:
    """The program's objects over the leaves: its scene, camera,
    RenderConfig and acceleration structure (None where the configuration
    names no builder)."""

    scene: object
    camera: object
    render_config: object
    accel: tuple | None


def build_program(config: dict, lv: dict, tv: np.ndarray) -> Program:
    """The port's scene, camera, ``RenderConfig(**config["render"])`` and
    the acceleration structure of ``config["accel"]`` over ``lv``."""
    from cpp_cuda_raytracer_dev_torch import (Camera, PhongParams, Pose,
                                              RenderConfig, Scene,
                                              SceneObject, Triangles)
    rc = RenderConfig(**config["render"])
    tris = Triangles(*[lv[f"tris.{n}"] for n in TRI_FIELDS],
                     lv["tris.color"])
    pose = Pose(lv["pose.quat"], lv["pose.translation"])
    phong = PhongParams(*[lv[f"phong.{k}"] for k in PHONG_FIELDS])
    cam = config["camera"]
    camera = Camera(*[lv[f"camera.{k}"] for k in CAMERA_FIELDS],
                    res_w=cam["res_w"], res_h=cam["res_h"])
    accel = None
    if config.get("accel"):
        spec = config["accel"]
        accel = plugins.load("accels", spec["builder"]).build(spec, tv, tris)
    return Program(Scene([SceneObject(tris, pose)], phong), camera, rc, accel)


def program_leaves(prog: Program) -> dict:
    """The program's parameters under the leaves' names."""
    obj = prog.scene.objects[0]
    out = {f"tris.{n}": getattr(obj.tris, n) for n in (*TRI_FIELDS,
                                                        "color")}
    out.update({f"pose.{n}": getattr(obj.pose, n)
                for n in ("quat", "translation")})
    out.update({f"phong.{n}": getattr(prog.scene.phong, n)
                for n in PHONG_FIELDS})
    out.update({f"camera.{n}": getattr(prog.camera, n)
                for n in CAMERA_FIELDS})
    return out


def build_kernels(config: dict, dev) -> None:
    """Build the program's kernel sources that the configuration names, in
    parallel, before their first launch (each builds once a checkout)."""
    if dev.type != "cuda" or not config.get("kernel_sources"):
        return
    from cpp_cuda_raytracer_dev_torch.ops.cuda import _build
    _build.build(*config["kernel_sources"])
