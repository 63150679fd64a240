#!/usr/bin/env python3
"""The compiled sharded frame and step across GPUs, one process a GPU.

    python3 chip_sharded.py [--world 4]

Builds the kernels once, then starts ``--world`` ranks over NCCL on
localhost (rank r on GPU r). Every rank holds the headline scene of
chip_smoke.py (``dragon_class_mesh(800_000)`` at 960x540, its 8 frames and
configurations) and, on the rays mesh (world,):
  1. an NCCL all-reduce and all-gather captured in a CUDA graph by the
     capture cache's own ``capture``, replayed bitwise on new inputs
     (chip_smoke.py ``nccl_capture_check``);
  2. ``render_sharded_jit`` against ``render_sharded`` for ``bin``,
     ``pallas2`` and ``kd`` (chip_smoke.py ``jit_frames``): frames 0, 1
     and 0 bitwise, one graph a method, 8 eager and 8 replayed frames in
     turns, one of each profiled, the method's kernel seen in the replay;
  3. ``make_train_step_jit`` with the mesh against ``make_train_step``, the
     all-leaves and pose/light/camera-only bin steps from twin parameter
     sets (chip_smoke.py ``jit_steps``): 3 steps bitwise, then 8 of each in
     turns, profiled; K1 (and K2, all leaves) seen in the replayed step;
  4. a regrowth: the all-leaves steps again from new twin sets, the camera
     moved and turned down before step 2 until one band's live count
     outgrows the agreed bucket and another's does not: every step bitwise
     the eager one, and every rank reports the same bucket after each step
     and one regrowth;
then ``render_sharded_jit`` bin on the ("rays", "prims") mesh
(world / 2, 2), as in 2. A failing check raises on its rank (the others
then stop at their next collective, so give the command a time limit).
Rank 0 prints each rank's log under ``build/chip_sharded/`` and, as the
last line, one JSON object with every rank's results; the exit code is 0
only when every rank passed. Needs ``--world`` CUDA devices.
"""

from __future__ import annotations

import argparse
import itertools
import json
import socket
import sys
import time
from pathlib import Path

import torch

LOGS = Path(__file__).resolve().parent / "build" / "chip_sharded"


def rank_main(rank: int, world: int, port: int) -> None:
    """One rank: the checks of the module docstring; writes its results to
    ``LOGS/rank<r>.json`` and its log to ``LOGS/rank<r>.log``."""
    sys.stdout = open(LOGS / f"rank{rank}.log", "w", buffering=1)
    sys.stderr = sys.stdout
    import subprocess

    import torch.distributed as dist

    import chip_smoke as cs
    from cpp_cuda_raytracer_dev_torch import ClusterAccel, RenderConfig, render
    from cpp_cuda_raytracer_dev_torch.parallel import mesh as pm
    from cpp_cuda_raytracer_dev_torch.parallel import render_pjit as pj
    from cpp_cuda_raytracer_dev_torch.utils.procgen import dragon_class_mesh

    t0 = time.perf_counter()
    pm.initialize_distributed(f"localhost:{port}", world, rank)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", str(dev.index)], capture_output=True,
        text=True, check=True, timeout=60).stdout.strip()
    res = {"rank": rank, "device": torch.cuda.get_device_name(dev),
           "card": smi}
    try:
        mesh = pm.make_mesh(world)
        cs.log(f"rank {rank} of {world} on {smi}, backend "
               f"{dist.get_backend()}, mesh {tuple(mesh.shape)}; band "
               f"{pm.ray_band(mesh, cs.RES_H)}")
        tv = dragon_class_mesh(cs.N_TRIS)
        frames = cs.headline_frames(dev, tv)
        configs = cs.headline_configs()
        cfg, c2 = configs["bin"], configs["pallas2"]
        accel = ClusterAccel.build(frames[0][0].objects[0].tris,
                                   c2.leaf_size)
        kd_tab = cs.kd_tables(dev, tv)
        with torch.inference_mode():
            target = render(*frames[0], cfg).radiance.clone()

        cs.nccl_capture_check(dev, mesh)
        res["frames"] = {
            method: cs.jit_frames(method, c, a, kname, frames, smi, mesh=mesh)
            for method, c, a, kname in (
                ("bin", cfg, None, "bin_intersect"),
                ("pallas2", c2, (accel,), "tile_intersect_v2"),
                ("kd", RenderConfig(method="kd"), (kd_tab,), "kd_traverse"))}
        res["steps"] = cs.jit_steps(dev, tv, cfg, None, "bin_intersect",
                                    target, smi, mesh=mesh,
                                    turns=cs.N_PAIRED)
        res["regrowth"] = regrowth(dev, tv, cfg, target, mesh)
        mesh2 = pm.make_mesh(world, prims=2)
        res["frames_2d_mesh"] = {"bin": cs.jit_frames(
            "bin (rays, prims) mesh", cfg, None, "bin_intersect", frames, smi,
            mesh=mesh2)}
        res["ok"] = True
    except Exception as e:
        res.update(ok=False, error=f"{type(e).__name__}: {e}")
        raise
    finally:
        res["seconds"] = time.perf_counter() - t0
        (LOGS / f"rank{rank}.json").write_text(json.dumps(res))
        pj.SHARDED_GRAPHS.clear()
        dist.destroy_process_group()


def regrowth(dev, tv, cfg, target, mesh) -> dict:
    """Step 4 of the module docstring."""
    import torch.distributed as dist

    import chip_smoke as cs
    from cpp_cuda_raytracer_dev_torch.models.renderer import bin_entry_count
    from cpp_cuda_raytracer_dev_torch.parallel import render_pjit as pj

    sets = {k: cs.train_set(dev, tv) for k in ("compiled", "eager")}
    steps = {k: (pj.make_train_step_jit if k == "compiled"
                 else pj.make_train_step)(
        torch.optim.SGD([*p["scene"].parameters(),
                         *p["camera"].parameters()], lr=cs.LR), cfg, mesh)
        for k, p in sets.items()}
    agree = pj.agreed_max(mesh)
    losses = {k: [float(steps[k](p, target))] for k, p in sets.items()}
    first = list(steps["compiled"].graphs().buckets.values())[0]
    cam = sets["compiled"]["camera"]
    # nearer and looking down: the upper bands fill, the lower ones empty
    for z, y in itertools.product((-3.0, -2.5, -2.0, -1.6, -1.2, -1.0),
                                  (-0.2, -0.4, -0.6, -0.8)):
        with torch.no_grad():
            for p in sets.values():
                p["camera"].pos.copy_(torch.tensor([0.0, 0.0, z]))
                p["camera"].look_at.copy_(torch.tensor([0.0, y, 0.0]))
        band = bin_entry_count(sets["compiled"]["scene"], cam, cfg,
                               *pj._band(cam, mesh))
        if agree(band) > first >= -agree(-band):
            break
    else:
        raise RuntimeError(f"no camera splits the bands about the bucket "
                           f"{first}")
    buckets = [first]
    for _ in range(2):
        for k, p in sets.items():
            losses[k].append(float(steps[k](p, target)))
        buckets.append(list(steps["compiled"].graphs().buckets.values())[0])
    same = all(torch.equal(a, b) for a, b in zip(
        [*sets["compiled"]["scene"].parameters(),
         *sets["compiled"]["camera"].parameters()],
        [*sets["eager"]["scene"].parameters(),
         *sets["eager"]["camera"].parameters()]))
    mine = {"band_live": band, "buckets": buckets,
            "regrown": steps["compiled"].graphs().regrown}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    lives = [e["band_live"] for e in every]
    split = min(lives) <= first < max(lives)
    lockstep = all(e["buckets"] == buckets and e["regrown"] == 1
                   for e in every)
    cs.log(f"regrowth: camera at z {z} looking at y {y}; live counts of the bands "
           f"{lives} against the bucket {first}; "
           f"buckets after each step {buckets}, regrowths "
           f"{[e['regrown'] for e in every]} on the ranks; losses "
           f"{losses['compiled']} / {losses['eager']}; parameters bitwise "
           f"the eager step's {same}")
    if not split:
        raise RuntimeError(f"the bands {lives} do not lie on both sides of "
                           f"the bucket {first}")
    if not (same and lockstep) or losses["compiled"] != losses["eager"]:
        raise RuntimeError("the regrown compiled step differs from the "
                           "eager one, or the ranks did not regrow together")
    return {**mine, "z": z, "look_at_y": y, "lockstep": lockstep,
            "bitwise": same}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--world", type=int, default=4)
    world = parser.parse_args().world
    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        raise SystemExit(f"chip_sharded: needs {world} CUDA devices, sees "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    from cpp_cuda_raytracer_dev_torch.ops.cuda import _build
    _build.build("bin_intersect", "segment_sum", "tile_intersect",
                 "kd_traverse")
    LOGS.mkdir(parents=True, exist_ok=True)
    for f in LOGS.glob("rank*"):
        f.unlink()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    failed = None
    try:
        torch.multiprocessing.spawn(rank_main, args=(world, port),
                                    nprocs=world)
    except Exception as e:           # a rank raised: report every rank
        failed = f"{type(e).__name__}: {e}"
    for r in range(world):
        print(f"==== rank {r} ====\n" + (LOGS / f"rank{r}.log").read_text(),
              flush=True)
    ranks = [json.loads(p.read_text()) if p.exists() else {"rank": r}
             for r, p in ((r, LOGS / f"rank{r}.json") for r in range(world))]
    ok = failed is None and all(r.get("ok") for r in ranks)
    print(json.dumps({"ok": ok, "world": world, "error": failed,
                      "ranks": ranks}), flush=True)
    if not ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
