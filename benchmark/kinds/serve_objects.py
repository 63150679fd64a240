"""A ``serve_objects`` mix: one viewer's closed loop of frames of a scene
of several posed objects over one mesh, through the program's compiled
frame, `render_jit`: the reference viewer's scene of two ``Object``s over
one ``Trixel`` list (its WinMain.cpp:152-156), the keys moving one of them
(:186-209).

The configuration's ``objects`` give each object's start pose (``quat``
as x, y, z, w and ``translation``); every object is an instance of the
configuration's mesh, and the program's objects share one ``Triangles``.
The mix's ``script`` moves the object ``moved`` from its start pose as the
``serve`` kind moves its one object (`serve.py`: R and T yaw it about its
own centre, W/S and Q/E move it along the camera's view and right axes);
the other objects stay at their start poses, as the reference's second
object does. The script is replayed cyclically from a tick drawn from the
seed.

A frame starts when the host writes every object's pose into one pinned
buffer (7 floats an object) and copies it to the device, where the poses'
leaves are views of one buffer; it ends when its ``image`` has been copied
into one pinned host buffer and that copy has completed, as in `serve.py`.

The check judges each pixel's choice of (object, triangle) as `serve.py`
judges a choice of triangle, against the plain reference over posed
objects (`reference/objects.py`): the pair is mapped to one id (object
times the mesh's triangles plus the triangle), so that `harness/check.py`'s
tie rules and numbers apply unchanged, with the reference's frame of the
program's choice, each object shaded with its own pose."""

from __future__ import annotations

import collections
import random
import time

import numpy as np
import torch

from benchmark.harness import check, plugins, scene as scene_mod
from benchmark.harness import trace as trace_mod
from benchmark.harness.runtime import Run
from benchmark.reference import objects as reference

serve = plugins.load("kinds", "serve")


def start_poses(config: dict) -> np.ndarray:
    """(N, 7) float64: each object's start quaternion and translation."""
    return np.asarray([[*o["quat"], *o["translation"]]
                       for o in config["objects"]], np.float64)


def cycle(mix: dict, config: dict, tv: np.ndarray) -> np.ndarray:
    """(C, N, 7) float32 poses of every object after each tick of one pass
    of the script: the others at their start poses, and the moved one
    from its start pose P0. The keys translate the object in the world and
    turn it about its own centre c, so after any ticks its pose is P0 put
    between them: x -> s + R0 (L (x - c) + c) + t0, where `serve.cycle`'s
    pose from the identity, x -> L x + t, is x -> s + L (x - c) + c."""
    start = start_poses(config)
    k = mix["moved"]
    q0, t0 = start[k, :4], start[k, 4:]
    c = (tv.min(axis=(0, 1)).astype(np.float64)
         + tv.max(axis=(0, 1)).astype(np.float64)) / 2
    one = serve.cycle(mix, config, tv).astype(np.float64)
    out = np.repeat(start[None], len(one), 0)
    for i, (q, t) in enumerate(zip(one[:, :4], one[:, 4:])):
        lc = serve._rotation(q) @ c
        s = t + lc - c
        out[i, k] = np.concatenate([serve._qmul(q0, q), s + serve._rotation(
            q0) @ (c - lc) + t0])
    return out.astype(np.float32)


def reference_inputs(config: dict, lv: dict, poses) -> tuple:
    """(tris, [pose], camera, phong) of `reference.objects` over the
    leaves ``lv`` and the objects' poses ``poses`` ((N, 7) rows)."""
    tris, _, camera, phong = scene_mod.reference_inputs(config, lv)
    dev = tris["geom"].device
    p = torch.as_tensor(np.asarray(poses), dtype=torch.float32, device=dev)
    return tris, [{"quat": r[0:4], "translation": r[4:7]} for r in p], \
        camera, phong


def ids(obj: torch.Tensor, tri: torch.Tensor, n_tris: int) -> torch.Tensor:
    """One id a choice of (object, triangle): object times ``n_tris`` plus
    the triangle; -1 on a miss."""
    obj, tri = obj.long(), tri.long()
    return torch.where(tri >= 0, obj * n_tris + tri, -1)


def judge(config: dict, lv: dict, poses, prog_frame: dict) -> dict:
    """The check's numbers of one frame: ``prog_frame`` (flat ``image``,
    ``radiance``, ``t``, ``tri``, ``obj``) against the reference over the
    objects at ``poses``."""
    args = reference_inputs(config, lv, poses)
    n = args[0]["geom"].shape[0]
    ref = reference.render_objects(*args, scene_mod.cull(config))
    chosen = reference.choice(*args, prog_frame["obj"], prog_frame["tri"])
    out = check.frame_numbers(
        dict(prog_frame, tri=ids(prog_frame["obj"], prog_frame["tri"], n)),
        dict(ref, tri=ids(ref["obj"], ref["tri"], n)), chosen)
    out["objects"] = sorted(int(k) for k in torch.unique(
        prog_frame["obj"]) if k >= 0)
    return out


def build_program(config: dict, lv: dict, staging: torch.Tensor):
    """The port's scene of the configuration's objects over one
    ``Triangles`` (object k's pose leaves views of ``staging[7k:7k+7]``),
    its camera and ``RenderConfig``."""
    from cpp_cuda_raytracer_dev_torch import (Camera, PhongParams, Pose,
                                              RenderConfig, Scene,
                                              SceneObject, Triangles)
    tris = Triangles(*[lv[f"tris.{n}"] for n in scene_mod.TRI_FIELDS],
                     lv["tris.color"])
    objects = [SceneObject(tris, Pose(staging[7 * k:7 * k + 4],
                                      staging[7 * k + 4:7 * k + 7]))
               for k in range(len(config["objects"]))]
    phong = PhongParams(*[lv[f"phong.{k}"] for k in scene_mod.PHONG_FIELDS])
    cam = config["camera"]
    camera = Camera(*[lv[f"camera.{k}"] for k in scene_mod.CAMERA_FIELDS],
                    res_w=cam["res_w"], res_h=cam["res_h"])
    return Scene(objects, phong), camera, RenderConfig(**config["render"])


def run(run: Run) -> dict:
    cell, dev = run.cell, run.device
    cfg, mix = cell.config, cell.traffic
    tv = scene_mod.vertices(cfg)
    lv = scene_mod.leaves(cfg, tv, dev)
    poses = cycle(mix, cfg, tv)
    start = serve.start_tick(run.seed, len(poses))
    n_obj = poses.shape[1]
    # every pose's leaves as views of one device buffer, filled from one
    # pinned host buffer each frame
    host = torch.zeros(7 * n_obj)
    if dev.type == "cuda":
        host = host.pin_memory()
    staging = host.to(dev)
    host_np = host.numpy()
    scene, camera, rc = build_program(cfg, lv, staging)
    from cpp_cuda_raytracer_dev_torch import render_jit
    from cpp_cuda_raytracer_dev_torch.models import renderer

    img_host = torch.empty((cfg["camera"]["res_h"], cfg["camera"]["res_w"],
                            3), dtype=torch.uint8,
                           pin_memory=dev.type == "cuda")
    clock = run.clock()

    def pose_of(i: int) -> np.ndarray:
        return poses[(start + i) % len(poses)]

    def frame(i: int):
        host_np[:] = pose_of(i).reshape(-1)
        clock.start()
        staging.copy_(host, non_blocking=True)
        out = render_jit(scene, camera, rc)
        img_host.copy_(out.image, non_blocking=True)
        return out, clock.stop()

    # warm-up: every pose of the script (any regrowth happens here), and as
    # many frames held as the check keeps
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
        if len(kept) < mix["check_frames"]:
            kept.append((i, out))
        else:
            j = pick.randrange(len(lat))
            if j < mix["check_frames"]:
                kept[j] = (i, out)

    t_start = run.window_start()
    traced = None
    if run.trace:
        n_traced = mix["trace_cycles"] * len(poses)
        traced = trace_mod.profile(
            lambda k: window_frame(i + k), n_traced, "serve",
            {"rays": cfg["camera"]["res_w"] * cfg["camera"]["res_h"],
             "triangles": tv.shape[0] * n_obj}, run.device_kind(), run.sync)
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

    prog_frames = [(idx, {"image": out.image.reshape(-1, 3),
                          "radiance": out.radiance.reshape(-1, 3),
                          "t": out.hit_t.reshape(-1),
                          "tri": out.hit_tri.reshape(-1),
                          "obj": out.hit_obj.reshape(-1)})
                   for idx, out in kept]
    del kept, scene, camera
    ref_lv = scene_mod.leaves(cfg, tv, dev)
    per_frame = [judge(cfg, ref_lv, pose_of(idx), out)
                 for idx, out in prog_frames]
    seen = sorted({k for f in per_frame for k in f["objects"]})
    lat_np = np.asarray(lat)
    return {"numbers": check.serve_numbers(per_frame), "attempted": len(lat),
            "failed": 0,
            "end_to_end": {"fps": len(lat) / window_s,
                           "frame_p95_ms": float(np.percentile(lat_np, 95))},
            "memory": memory, "trace": traced,
            "note": f"checked frames {[idx for idx, _ in prog_frames]} "
                    f"(script ticks from {start}); objects seen {seen}; "
                    f"ties {check.tie_summary(per_frame)}"}


def control(run: Run) -> dict:
    """The control's numbers: the reference in TF32 put in the program's
    place, over the mix's ``check_frames`` poses of the script drawn from
    the seed."""
    cfg, mix = run.cell.config, run.cell.traffic
    tv = scene_mod.vertices(cfg)
    lv = scene_mod.leaves(cfg, tv, run.device)
    poses = cycle(mix, cfg, tv)
    idx = random.Random(run.seed).sample(range(len(poses)),
                                         mix["check_frames"])
    frames = []
    for i in idx:
        low = reference.render_objects(
            *reference_inputs(cfg, lv, poses[i]), scene_mod.cull(cfg),
            precision="tf32")
        frames.append(judge(cfg, lv, poses[i], low))
    return {"control": check.serve_numbers(frames),
            "ties": check.tie_summary(frames)}
