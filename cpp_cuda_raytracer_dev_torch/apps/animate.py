"""Offline animation driver: the frame loop of WinMain, headless (the JAX
package's ``apps/animate.py``, with the same flags, plus ``--device``).

Replays a key script (models/animation.py) through `render_jit` (on CUDA
one captured frame, replayed with each tick's poses), writing
PNG frames and printing the reference's HUD block (resolution, FPS, camera
basis; WinMain.cpp:225-234) in place via VT escapes. With
``--second-object`` a second posed instance of the mesh shares the first
one's `Triangles` (WinMain.cpp:152-156). ``--json-out`` writes the run's
steady-state frame time from `device_time` (CUDA events on the card).

Usage:
    python -m cpp_cuda_raytracer_dev_torch.apps.animate \\
        --mesh mesh.ply --out frames --res 512 288 --frames 60

It runs on the CUDA device unless ``--device cpu`` is given, and exits with
an error where there is no CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--mesh", required=True)
    p.add_argument("--out", default=None, help="frame output dir (PNG)")
    p.add_argument("--res", type=int, nargs=2, default=[480, 270])
    p.add_argument("--frames", type=int, default=0,
                   help="cap on total frames (0 = full script)")
    p.add_argument("--method", default="bin",
                   help="intersect backend; 'bin' is the flagship "
                        "(screen-space binning + kernel K1)")
    p.add_argument("--leaf-size", type=int, default=128)
    p.add_argument("--json-out", default=None,
                   help="write a JSON artifact with the steady-state "
                        "frame time after the run")
    p.add_argument("--max-candidates", type=int, default=32)
    p.add_argument("--second-object", action="store_true",
                   help="add a second posed instance of the mesh "
                        "(multi-mesh demo, WinMain.cpp:152-156)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' must be asked for")
    args = p.parse_args(argv)

    from .render_cli import device_from_arg
    dev = device_from_arg(args.device, p)

    from .. import (Camera, Pose, RenderConfig, Scene, SceneObject, Triangles,
                    render_jit)
    from ..accel.methods import build_accel
    from ..io import ply
    from ..models.animation import demo_script, run_script
    from ..ops.quaternion import from_axis_angle
    from ..utils.image import Hud, write_png
    from ..utils.profiling import device_time

    mesh = ply.load_mesh(args.mesh)
    tris = Triangles.from_vertices(mesh.tri_vertices, device=dev)
    lo = mesh.tri_vertices.reshape(-1, 3).min(0)
    hi = mesh.tri_vertices.reshape(-1, 3).max(0)
    center, size = (lo + hi) / 2, float(np.linalg.norm(hi - lo))

    objects = [SceneObject(tris)]
    if args.second_object:
        pose = Pose(from_axis_angle([0.0, 1.0, 0.0], 0.8, device=dev),
                    torch.tensor([size * 0.6, 0.0, size * 0.2],
                                 dtype=torch.float32, device=dev))
        objects.append(SceneObject(tris, pose))
    scene = Scene(objects)

    w, h = args.res
    camera = Camera.create(
        w, h, pos=center + np.array([0, 0.1 * size, -1.2 * size]),
        look_at=center, up=[0, 1, 0], film_h=0.024, focal=0.035, device=dev)
    config = RenderConfig(method=args.method, leaf_size=args.leaf_size,
                          max_candidates=args.max_candidates,
                          draw_distance=max(400.0, 10 * size))
    accel = build_accel(args.method, [o.tris for o in objects],
                        args.leaf_size)

    if args.out:
        os.makedirs(args.out, exist_ok=True)
    hud = Hud()
    n, u, v = (x.tolist() for x in camera.basis())
    cpos = camera.pos.tolist()
    t_prev = time.perf_counter()
    total = 0
    for tick, key, scene in run_script(scene, camera, demo_script()):
        img = render_jit(scene, camera, config, accel).image.cpu().numpy()
        t_now = time.perf_counter()
        fps = 1.0 / max(t_now - t_prev, 1e-9)
        t_prev = t_now
        if args.out:
            write_png(os.path.join(args.out, f"frame_{tick:04d}.png"), img)
        hud.update([
            f"Resolution: {w} x {h}",
            f"Key: {key}   Frame: {tick}",
            f"wall-FPS (incl. host transfer): {fps:.2f}",
            f"CameraPos [x:{cpos[0]:.4f} y:{cpos[1]:.4f} z:{cpos[2]:.4f}]",
            f"Camera N [x:{n[0]:.4f} y:{n[1]:.4f} z:{n[2]:.4f}]",
            f"Camera U [x:{u[0]:.4f} y:{u[1]:.4f} z:{u[2]:.4f}]",
            f"Camera V [x:{v[0]:.4f} y:{v[1]:.4f} z:{v[2]:.4f}]",
        ])
        total += 1
        if args.frames and total >= args.frames:
            break
    print(f"\nrendered {total} frames")

    # the HUD FPS above is wall clock between host copies of the image; the
    # steady-state number is the frame's device time on the final pose
    dt = device_time(lambda i: render_jit(scene, camera, config,
                                          accel).image,
                     n_lo=1, n_hi=1, device=dev)
    kind = "device" if dev.type == "cuda" else "CPU wall-clock"
    print(f"steady-state {kind} frame: {dt * 1e3:.2f} ms "
          f"({1.0 / dt:.1f} FPS, {w * h / dt:.3e} rays/s)")
    if args.json_out:
        on_card = dev.type == "cuda"
        with open(args.json_out, "w") as f:
            json.dump({
                "mesh": args.mesh, "method": args.method,
                "resolution": [w, h], "frames": total,
                "objects": len(objects),
                "device": torch.cuda.get_device_name(dev) if on_card
                else "cpu",
                ("device_ms_per_frame" if on_card
                 else "cpu_ms_per_frame"): dt * 1e3,
                "fps": 1.0 / dt,
                "rays_per_sec": w * h / dt,
                "timing": "device_time: " + (
                    "CUDA events around each of 3 frames, median"
                    if on_card else "wall clock on the CPU"),
            }, f, indent=2)


if __name__ == "__main__":
    main()
