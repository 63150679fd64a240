"""A ``serve`` mix: one viewer's closed loop of frames through the
program's compiled frame, `render_jit`, the object's pose driven by the
reference viewer's keys.

The reference viewer (its WinMain.cpp:174-239, the key bindings :186-209;
the port's ``models/animation.py``) updates the object's pose on each
input tick from the key held: R and T compose the key quaternion
``key_quat`` or its conjugate on the right, pivoting about the object's
centre (the mid-point of its box, carried by the pose); W and S move the
object by ``cam_speed`` along the camera's view axis n and back, Q and E
along its right axis u and back. A mix's ``script`` lists (key, ticks)
held in turn. The generator replays it cyclically, one tick a frame, from
a tick drawn from the seed: every seed shows the same poses, in another
phase. The camera stays where the configuration puts it.

A frame starts when the host writes its pose into a pinned buffer and
copies it to the device, where the pose's leaves are views of one buffer;
it ends when its ``image`` (H x W x 3 uint8) has been copied into one
pinned host buffer, the one a viewer displays, and that copy has
completed. The next frame starts then. Each frame's latency runs from an
event before the pose's copy to an event after the image's, on the
device's clock; the frames a second are the frames completed over the
window's seconds on the host's clock."""

from __future__ import annotations

import collections
import random
import time

import numpy as np
import torch

from benchmark.harness import check, scene as scene_mod, trace as trace_mod
from benchmark.harness.runtime import Run
from benchmark.reference import render as reference

KEYS = {"W": ("n", 1.0), "S": ("n", -1.0), "Q": ("u", 1.0),
        "E": ("u", -1.0), "R": ("yaw", 1.0), "T": ("yaw", -1.0)}


def _qmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Hamilton product of (x, y, z, w) quaternions."""
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array([ay * bz - az * by + ax * bw + aw * bx,
                     az * bx - ax * bz + ay * bw + aw * by,
                     ax * by - ay * bx + az * bw + aw * bz,
                     aw * bw - ax * bx - ay * by - az * bz])


def _rotation(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y]])


def _unit(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def camera_axes(config: dict) -> dict:
    """The camera's view axis n and right axis u (its Camera.cpp:32-58)."""
    cam = config["camera"]
    n = _unit(np.asarray(cam["look_at"], np.float64)
              - scene_mod.camera_start(config))
    up = _unit(np.asarray(cam["up"], np.float64))
    v = _unit(np.cross(n, np.cross(up, n)))
    return {"n": n, "u": np.cross(v, n)}


def cycle(mix: dict, config: dict, tv: np.ndarray) -> np.ndarray:
    """(C, 7) float32 poses (quaternion x, y, z, w, then translation), the
    pose after each tick of one pass of the script from the identity; C is
    the script's ticks. Worked in float64."""
    axes = camera_axes(config)
    centre = (tv.min(axis=(0, 1)).astype(np.float64)
              + tv.max(axis=(0, 1)).astype(np.float64)) / 2
    key_q = np.asarray(mix["key_quat"], np.float64)
    q, t = np.array([0.0, 0.0, 0.0, 1.0]), np.zeros(3)
    out = []
    for key, ticks in mix["script"]:
        what, sign = KEYS[key]
        for _ in range(ticks):
            if what == "yaw":
                dq = key_q * [sign, sign, sign, 1.0]
                new_q = _qmul(q, dq)
                new_q /= np.linalg.norm(new_q)
                pivot = _rotation(q) @ centre + t
                spin = _qmul(new_q, q * [-1.0, -1.0, -1.0, 1.0])
                t = pivot + _rotation(spin) @ (t - pivot)
                q = new_q
            else:
                t = t + sign * mix["cam_speed"] * axes[what]
            out.append(np.concatenate([q, t]))
    return np.asarray(out, np.float32)


def start_tick(seed: int, ticks: int) -> int:
    """The tick of the cycle that a seed's first frame shows."""
    return random.Random(seed).randrange(ticks)


def _pose_leaves(lv: dict, pose: np.ndarray, dev) -> dict:
    p = torch.as_tensor(pose, device=dev)
    return dict(lv, **{"pose.quat": p[0:4], "pose.translation": p[4:7]})


def _judge(cfg: dict, lv: dict, prog_frame: dict) -> dict:
    """The check's numbers of one frame: ``prog_frame`` (flat ``image``,
    ``radiance``, ``t``, ``tri``) against the reference on the leaves
    ``lv``."""
    args = scene_mod.reference_inputs(cfg, lv)
    ref = reference.render(*args, scene_mod.cull(cfg))
    chosen = reference.choice(*args, prog_frame["tri"].long())
    return check.frame_numbers(prog_frame, ref, chosen)


def run(run: Run) -> dict:
    cell, dev = run.cell, run.device
    cfg, mix = cell.config, cell.traffic
    tv = scene_mod.vertices(cfg)
    lv = scene_mod.leaves(cfg, tv, dev)
    poses = cycle(mix, cfg, tv)
    start = start_tick(run.seed, len(poses))
    # the pose's leaves as views of one device buffer, filled from a
    # pinned host buffer each frame
    host = torch.zeros(7)
    if dev.type == "cuda":
        host = host.pin_memory()
    staging = host.to(dev)
    lv["pose.quat"], lv["pose.translation"] = staging[0:4], staging[4:7]
    host_np = host.numpy()
    prog = scene_mod.build_program(cfg, lv, tv)
    from cpp_cuda_raytracer_dev_torch import render_jit
    from cpp_cuda_raytracer_dev_torch.models import renderer

    img_host = torch.empty((cfg["camera"]["res_h"], cfg["camera"]["res_w"],
                            3), dtype=torch.uint8,
                           pin_memory=dev.type == "cuda")
    clock = run.clock()

    def pose_of(i: int) -> np.ndarray:
        return poses[(start + i) % len(poses)]

    def frame(i: int):
        host_np[:] = pose_of(i)
        clock.start()
        staging.copy_(host, non_blocking=True)
        out = render_jit(prog.scene, prog.camera, prog.render_config,
                         prog.accel)
        img_host.copy_(out.image, non_blocking=True)
        return out, clock.stop()

    # warm-up: every pose of the script, so that any regrowth of the
    # program's buckets happens here; it also holds as many frames as the
    # check keeps, so that the allocator has their memory before the window
    held = collections.deque(maxlen=mix["check_frames"] + 1)
    i = 0
    for i in range(mix["warmup_cycles"] * len(poses)):
        held.append(frame(i)[0])
    held.clear()
    i += 1
    captures = renderer.FRAME_GRAPHS.captures
    pick = random.Random(run.seed * 2 + 1)
    kept: list = []
    lat: list = []

    def window_frame(i: int):
        out, ms = frame(i)
        lat.append(ms)
        n = len(lat)
        if len(kept) < mix["check_frames"]:
            kept.append((i, out))
        else:
            j = pick.randrange(n)
            if j < mix["check_frames"]:
                kept[j] = (i, out)

    t_start = run.window_start()
    traced = None
    if run.trace:
        # whole cycles of the script, so that every seed traces every pose
        n_traced = mix["trace_cycles"] * len(poses)
        traced = trace_mod.profile(
            lambda k: window_frame(i + k), n_traced, "serve",
            {"rays": cfg["camera"]["res_w"] * cfg["camera"]["res_h"],
             "triangles": tv.shape[0]}, run.device_kind(), run.sync)
        i += n_traced
    while time.perf_counter() - t_start < run.seconds:
        window_frame(i)
        i += 1
    run.sync()
    window_s = time.perf_counter() - t_start
    in_window = renderer.FRAME_GRAPHS.captures - captures
    run.log(f"frames {len(lat)} in {window_s:.4f} s; graphs captured in "
            f"the window {in_window}, regrowths "
            f"{renderer.FRAME_GRAPHS.regrown}, buckets "
            f"{list(renderer.FRAME_GRAPHS.buckets.values())}")
    if in_window:
        raise RuntimeError(f"{in_window} graphs were captured inside the "
                           "window")
    memory = run.memory_peak()

    # the check: the kept frames against the reference on their poses
    prog_frames = [(idx, {"image": out.image.reshape(-1, 3),
                          "radiance": out.radiance.reshape(-1, 3),
                          "t": out.hit_t.reshape(-1),
                          "tri": out.hit_tri.reshape(-1)})
                   for idx, out in kept]
    del kept, prog
    ref_lv = scene_mod.leaves(cfg, tv, dev)
    per_frame = [_judge(cfg, _pose_leaves(ref_lv, pose_of(idx), dev), out)
                 for idx, out in prog_frames]
    lat_np = np.asarray(lat)
    return {"numbers": check.serve_numbers(per_frame), "attempted": len(lat),
            "failed": 0,
            "end_to_end": {"fps": len(lat) / window_s,
                           "frame_p95_ms": float(np.percentile(lat_np, 95))},
            "memory": memory, "trace": traced,
            "note": f"checked frames {[idx for idx, _ in prog_frames]} "
                    f"(script ticks from {start}); ties "
                    f"{check.tie_summary(per_frame)}"}


def control(run: Run) -> dict:
    """The control's numbers: the reference in TF32 (`reference.tf32`) put
    in the program's place, over the mix's ``check_frames`` poses of the
    script drawn from the seed."""
    cfg, mix = run.cell.config, run.cell.traffic
    tv = scene_mod.vertices(cfg)
    lv = scene_mod.leaves(cfg, tv, run.device)
    poses = cycle(mix, cfg, tv)
    idx = random.Random(run.seed).sample(range(len(poses)),
                                         mix["check_frames"])
    frames = []
    for i in idx:
        plv = _pose_leaves(lv, poses[i], run.device)
        low = reference.render(*scene_mod.reference_inputs(cfg, plv),
                               scene_mod.cull(cfg), precision="tf32")
        frames.append(_judge(cfg, plv, low))
    return {"control": check.serve_numbers(frames),
            "ties": check.tie_summary(frames)}
