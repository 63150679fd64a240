"""Keyboard-semantics animation: scripted pose updates per tick (the JAX
package's ``models/animation.py``).

The reference's interactivity is a 30 Hz input tick inside the frame loop
(``WinMain.cpp:174-239``): held keys stage a quaternion/translation into
``Input`` (Input.cpp:6-19) and apply it to the object pose
(Camera.cu:254-330). Headless, the equivalent is a *key script*: a sequence
of (key, ticks) pairs replayed by the offline driver (apps/animate.py),
each tick making a new `Pose` for one object. The scene's `Triangles`
modules are shared by every scene a tick makes: geometry never moves or
re-uploads.

Key bindings (WinMain.cpp:186-209):
  W/S  translate the object along the camera view axis n by ±cam_speed
  Q/E  strafe along the camera right axis u by ±cam_speed
  R/T  yaw the object about +y/-y by the fixed key quaternion
       (0, 0.0995..., 0, 0.9950...), pivoting about the object itself
       (the recentring at Camera.cu:288-329)
"""

from __future__ import annotations

import dataclasses

import torch

from .camera import Camera
from .scene import Scene, SceneObject

CAM_SPEED = 0.005          # WinMain.cpp:171
KEY_QUAT_SIN = 0.09950371902099893   # WinMain.cpp:187
KEY_QUAT_COS = 0.9950371902099893


@dataclasses.dataclass(frozen=True)
class KeyEvent:
    key: str     # one of W S Q E R T
    ticks: int   # how many 30Hz ticks the key is held


def _yaw_quat(sign: float, device) -> torch.Tensor:
    return torch.tensor([0.0, sign * KEY_QUAT_SIN, 0.0, KEY_QUAT_COS],
                        dtype=torch.float32, device=device)


@torch.no_grad()
def apply_key(scene: Scene, camera: Camera, key: str,
              obj_index: int = 0) -> Scene:
    """One tick of one held key -> a new scene with a new pose for object
    ``obj_index``; every object keeps its `Triangles`."""
    obj = scene.objects[obj_index]
    n, u, _ = camera.basis()
    if key == "W":
        pose = obj.pose.translated(n * CAM_SPEED)
    elif key == "S":
        pose = obj.pose.translated(-n * CAM_SPEED)
    elif key == "Q":
        pose = obj.pose.translated(u * CAM_SPEED)
    elif key == "E":
        pose = obj.pose.translated(-u * CAM_SPEED)
    elif key in ("R", "T"):
        pivot = obj.pose.apply(obj.tris.centroid())
        dq = _yaw_quat(1.0 if key == "R" else -1.0, pivot.device)
        pose = obj.pose.rotated(dq, pivot=pivot)
    else:
        raise ValueError(f"unknown key {key!r}")
    objects = list(scene.objects)
    objects[obj_index] = SceneObject(obj.tris, pose)
    return Scene(objects, scene.phong)


def run_script(scene: Scene, camera: Camera, script: list[KeyEvent],
               obj_index: int = 0):
    """Yields (tick_index, key, scene) after each tick of the script."""
    tick = 0
    for ev in script:
        for _ in range(ev.ticks):
            scene = apply_key(scene, camera, ev.key, obj_index)
            yield tick, ev.key, scene
            tick += 1


def demo_script() -> list[KeyEvent]:
    """Dolly in, orbit, strafe: a deterministic showcase path."""
    return [KeyEvent("W", 30), KeyEvent("R", 20), KeyEvent("Q", 15),
            KeyEvent("T", 40), KeyEvent("E", 15), KeyEvent("S", 30),
            KeyEvent("R", 20)]
