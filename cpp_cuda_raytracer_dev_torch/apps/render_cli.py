"""Single-frame render CLI: load a PLY, build the accel, render, write a PNG
(the JAX package's ``apps/render_cli.py``, with the same flags and printout,
plus ``--device``).

The minimal "WinMain" equivalent: scene setup (WinMain.cpp:69-156) plus one
frame, with the reference's hardcoded choices exposed as flags. Frames run
through `render_jit`, as the JAX app's do through its ``render_jit``: on
CUDA the steady-state frame is the replayed CUDA graph.

Usage:
    python -m cpp_cuda_raytracer_dev_torch.apps.render_cli \\
        --mesh mesh.ply --out frame.png --res 960 540 --method bin

It runs on the CUDA device unless ``--device cpu`` is given, and exits with
an error where there is no CUDA device: it never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

METHODS = ["brute", "fixed", "grid", "pallas", "pallas2", "kd", "bin"]


def device_from_arg(name: str, parser: argparse.ArgumentParser
                    ) -> torch.device:
    """The --device flag's device; a parser error if it is CUDA and there is
    no CUDA device."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        parser.error("no CUDA device (torch.cuda.is_available() is false); "
                     "pass --device cpu to render on the CPU")
    return dev


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--mesh", required=True)
    p.add_argument("--out", default="frame.png")
    p.add_argument("--res", type=int, nargs=2, default=[960, 540])
    p.add_argument("--method", default="bin", choices=METHODS)
    p.add_argument("--leaf-size", type=int, default=128)
    p.add_argument("--max-candidates", type=int, default=48)
    p.add_argument("--pos", type=float, nargs=3, default=None)
    p.add_argument("--look-at", type=float, nargs=3, default=None)
    p.add_argument("--focal", type=float, default=0.055)
    p.add_argument("--color", type=float, nargs=3,
                   default=[0.1, 0.55, 0.20])  # WinMain.cpp:118-120
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' must be asked for")
    args = p.parse_args(argv)
    dev = device_from_arg(args.device, p)

    from .. import (Camera, RenderConfig, Scene, SceneObject, Triangles,
                    render_jit)
    from ..accel.methods import build_accel
    from ..io import ply
    from ..utils.image import write_png
    from ..utils.profiling import device_time

    t0 = time.perf_counter()
    mesh = ply.load_mesh(args.mesh)
    print(f"loaded {mesh.num_triangles} triangles "
          f"in {time.perf_counter() - t0:.2f}s")

    tris = Triangles.from_vertices(mesh.tri_vertices, device=dev,
                                   color=np.asarray(args.color, np.float32))
    scene = Scene([SceneObject(tris)])
    lo = mesh.tri_vertices.reshape(-1, 3).min(0)
    hi = mesh.tri_vertices.reshape(-1, 3).max(0)
    center, size = (lo + hi) / 2, float(np.linalg.norm(hi - lo))
    pos = (np.asarray(args.pos, np.float32) if args.pos
           else center + np.array([0, 0.1 * size, -1.2 * size]))
    look = (np.asarray(args.look_at, np.float32) if args.look_at else center)

    w, h = args.res
    camera = Camera.create(w, h, pos=pos, look_at=look, up=[0, 1, 0],
                           film_h=0.024, focal=args.focal, device=dev)
    config = RenderConfig(method=args.method, leaf_size=args.leaf_size,
                          max_candidates=args.max_candidates,
                          draw_distance=max(400.0, 10 * size))

    t0 = time.perf_counter()
    accel = build_accel(args.method, [tris], args.leaf_size)
    if accel is not None:
        print(f"{type(accel[0]).__name__} build: "
              f"{time.perf_counter() - t0:.2f}s")

    t0 = time.perf_counter()
    out = render_jit(scene, camera, config, accel)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(f"first frame (incl. kernel build and capture): "
          f"{time.perf_counter() - t0:.2f}s")
    dt = device_time(lambda i: render_jit(scene, camera, config,
                                          accel).image,
                     n_lo=1, n_hi=1, device=dev)
    kind = "device" if dev.type == "cuda" else "CPU wall-clock"
    print(f"steady-state frame ({kind}): {dt * 1e3:.2f} ms "
          f"({1 / dt:.1f} FPS, {w * h / dt:.3e} rays/s)")

    hit_rate = float((out.hit_tri >= 0).float().mean())
    print(f"hit rate: {hit_rate:.3f}")
    write_png(args.out, out.image.cpu().numpy())
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
