#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's ``method="bin"`` frame and its training step, the
cluster paths ``method="pallas2"`` and ``"pallas"``, the per-tile bin
kernel K6, and the apps ``render_cli`` and ``animate``, at the headline size:
the dragon-class mesh (``dragon_class_mesh(800_000)``, 800,130 triangles)
at 960x540, 16x32 tiles, the bench camera (pos (0, 0, -3), look-at the
origin, film_h 0.024, focal 0.055); bin_chunk 512 and backface cull for
the bin path; for the cluster paths ``bench.py --method pallas2``'s
configuration: 128-triangle clusters (8,192), 64 candidates a tile, a
two-level cull through 24 groups of 32 clusters, escalation of the 64
worst tiles at 4x the candidates.

Phases (any failure raises and the process exits non-zero):
  1. the card (nvidia-smi name, power limit and maximum SM clock), versions,
     the build of every kernel (one nvcc per source, in parallel);
  2. the bin-intersect kernel against its plain PyTorch version on the same
     binned tensors (a 96x64 sphere and the headline frame): triangle ids
     equal and t bitwise equal; both timed with CUDA events;
  3. serve 8 frames at distinct camera positions and object poses through
     ``render``, each timed with CUDA events, after resetting the kernel's
     launch counter; the counter must show the frames went through it;
  4. frame 0 against the ``mt_fixed_origin`` oracle on 4,096 sampled rays
     (seed 0): agreement >= 0.999;
  5. the segment-sum kernel (K2) against its plain version on the card, on
     synthetic cases (one at the headline size with half the rows on one
     id) and on the cotangent block of the first headline training step:
     within n·2⁻²³·Σ|x| of a float64 sum per id, two launches bitwise
     equal; each synthetic case again on integer rows, whose sums float32
     holds exactly, where both must equal the float64 sum bitwise (a
     dropped or doubled run of a long segment fails there); timed beside
     the plain version, autograd's
     default backward (``index_add_`` on the unsorted rows) and the whole
     gather backward (sort + permute + kernel);
  6. training: the bench's weighted-radiance gradient over every scene and
     camera leaf (finite, table gradients not all 0), then 5
     ``make_train_step`` steps with SGD(lr 1e-4) toward frame 0's image from
     a pose turned by 1 degree, each timed with CUDA events; both kernels'
     counters are reset just before the steps and must show >= 5 launches;
     then one step split into forward, backward and SGD, and one profiled
     step (device busy ms and device operations);
  7. the pose/light/camera-only step (triangle tables frozen), 3 steps: the
     segment-sum counter must not move; split and profiled as in 6;
  8. telemetry (kernel K3): frame 0 through ``intersect_binned`` with
     ``with_stats`` at esub 1 (bitwise phase 3's hits) and esub 4; the
     kernel against its plain version on frame 0's operands at esub 1 and
     4 (t, tri and steps bitwise equal); the ray-entry pairs K1 scanned
     give its bound; kernel and frame timed with and without the
     telemetry;
  9. the cluster paths: build the ClusterAccel (seconds, clusters); the
     tile-intersect kernels K4 and K5 against their plain versions on the
     same operands (a 96x64 sphere, headline frame 0, and a grazing view
     with 4 candidates a tile whose overflow forces escalation: the first
     pass and the escalation pass), ids equal and t bitwise equal, timed
     with CUDA events; 8 "pallas2" and 3 "pallas" frames through ``render``
     at phase 3's cameras and poses after resetting both launch counters,
     which must show the frames went through the kernels; frame 0 of each
     and one "grid" frame against phase 4's oracle rays (agreement >=
     0.999); one profiled frame of each path (device busy ms, device
     operations); one "pallas2" training step (every gradient finite); the
     telemetry of frame 0 (candidates visited, rays that passed each box
     test, residual overflow); each candidate's rays past its box test,
     times its cluster's triangle count, give both kernels' bounds;
 10. the per-tile bin kernel K6 at chunk 128 on the port's own binning:
     its entry point (bin_object -> tile_operands -> kernel -> decode_enc)
     on phase 3's 8 frames after resetting its launch counter, which must
     show them; the kernel against its plain version on the 96x64 sphere
     and headline frame 0 at debug_mode 0, 1 and 2 (t bitwise, enc, steps
     and decoded ids equal; the same hits in every mode); its decoded ids
     against K1's on frame 0, every differing ray printed and required to
     be a tie by the mt_fixed_origin oracle (both triangles' t within 1e-5
     of the oracle's); agreement with phase 4's oracle rays >= 0.999;
     kernel and plain version timed with CUDA events; the chunks whose
     gate opened and the walked chunks' constants give its bound;
 11. the entry points: the headline mesh written as a binary PLY under
     build/chip_smoke/, then ``render_cli.main`` with ``--method bin`` and
     ``pallas2`` at 960x540 and ``kd`` at 320x180 (a validation path with
     no kernel), each PNG's hit/miss against the oracle on 4,096 sampled
     rays of the same camera (agreement >= 0.999) and each kernel path's
     launch counter moved; then ``animate.main`` for 30 ticks at 960x540
     with ``--second-object --method bin --json-out``: two objects, K1
     twice a frame, which its launch counter must show.
Each phase prints its seconds. Prints a JSON line of per-kernel results,
then, as the last line,
``{"ok": true, "device": {...}}``. Needs a CUDA device and never falls back
to the CPU.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

RES_W, RES_H = 960, 540
N_TRIS = 800_000
N_FRAMES = 8
N_SAMPLE = 4096
MIN_AGREE = 0.999
KERNEL_REPS = 20
PLAIN_REPS = 3
N_TRAIN_STEPS = 5
N_POSE_STEPS = 3
LR = 1e-4
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
N_SMS, FP32_LANES = 132, 128   # per SM; peak = SMs x lanes x 2 x clock
K1_OPS_PER_PAIR = 31           # csrc/bin_intersect.cu, "Bound"
K4_OPS_PER_PAIR = 29           # csrc/tile_intersect.cu, "Bound"
K5_OPS_PER_PAIR = 26
K6_OPS_PER_PAIR = 29           # csrc/bin_tile_intersect.cu, "Bound"
K6_OPS_PER_ENTRY = 52          # its constants (51) and depth minimum, a chunk
K6_CHUNK = 128
KD_RES = (320, 180)            # the KD path is a validation path, no kernel
N_ANIMATE_TICKS = 30
BACKGROUND = (240, 130, 0)
N_CLUSTER_FRAMES = {"pallas2": 8, "pallas": 3}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` calls, after one
    warm-up call, from CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_profile(fn):
    """Run ``fn()`` once under torch.profiler. Returns (device busy ms,
    device operations, the 8 largest device kernels as (name, count, ms)).
    Only device events count: an aten op's own device time repeats its
    kernels'."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    on_dev = [a for a in prof.key_averages()
              if a.device_type == DeviceType.CUDA]
    on_dev.sort(key=lambda a: -a.self_device_time_total)
    top = [(a.key[:48], a.count, a.self_device_time_total / 1e3)
           for a in on_dev[:8]]
    return (sum(a.self_device_time_total for a in on_dev) / 1e3,
            sum(a.count for a in on_dev), top)


def phase_timer():
    """phase_done(n) logs the seconds since the previous call."""
    last = [time.perf_counter()]

    def phase_done(n: int) -> None:
        now = time.perf_counter()
        log(f"phase {n}: {now - last[0]:.1f} s")
        last[0] = now
    return phase_done


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs only on a CUDA device")
    from cpp_cuda_raytracer_dev_torch import (Camera, Pose, RenderConfig,
                                              Scene, SceneObject, Triangles,
                                              render)
    from cpp_cuda_raytracer_dev_torch.accel.traverse import bin_object
    from cpp_cuda_raytracer_dev_torch.models.renderer import trace_rays
    from cpp_cuda_raytracer_dev_torch.ops.cuda import _build
    from cpp_cuda_raytracer_dev_torch.ops.cuda import bin_intersect as k1
    from cpp_cuda_raytracer_dev_torch.ops.quaternion import from_axis_angle
    from cpp_cuda_raytracer_dev_torch.utils.procgen import (dragon_class_mesh,
                                                            uv_sphere)

    dev = torch.device("cuda", 0)
    phase_done = phase_timer()

    # ---- 1. the card, versions, build ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("float32 matmuls must stay full float32")
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    log(f"max SM clock {clock_mhz} MHz")
    t0 = time.perf_counter()
    built = _build.build("bin_intersect", "segment_sum", "tile_intersect",
                         "bin_tile_intersect")
    log(f"built {', '.join(lib.name for lib, _ in built.values())} in "
        f"{time.perf_counter() - t0:.2f} s")
    for _, build_log in built.values():
        for line in build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")

    cfg = RenderConfig(method="bin", tile_h=16, tile_w=32, bin_chunk=512,
                       backface_cull=True)
    chunk = cfg.bin_chunk
    phase_done(1)

    # ---- 2. kernel vs plain version on identical binned tensors ----
    def binned_case(tv, res_w, res_h, cull):
        tris = Triangles.from_vertices(tv, device=dev)
        cam = Camera.create(res_w, res_h, pos=[0.0, 0.0, -3.0],
                            look_at=[0.0, 0.0, 0.0], up=[0.0, 1.0, 0.0],
                            film_h=0.024, focal=0.055, device=dev)
        c = RenderConfig(method="bin", tile_h=16, tile_w=32,
                         bin_chunk=chunk, backface_cull=cull)
        with torch.inference_mode():
            rays, b = bin_object(cam.pos, tris, cam.projection(), c, res_h,
                                 res_w)
        return rays, b

    headline_tv = dragon_class_mesh(N_TRIS)
    cases = [("sphere 96x64", uv_sphere(50, 50), 96, 64, False),
             ("sphere 96x64 cull", uv_sphere(50, 50), 96, 64, True),
             ("dragon-class 960x540 cull", headline_tv, RES_W, RES_H, True)]
    max_abs_err = 0.0
    with torch.inference_mode():
        for name, tv, w, h, cull in cases:
            rays, b = binned_case(tv, w, h, cull)
            ops = (rays, b.geom, b.entry_tri, b.starts, chunk)
            kt, ktri = k1.bin_intersect(*ops)
            torch.cuda.synchronize()
            rt, rtri = k1.bin_intersect_reference(*ops)
            torch.cuda.synchronize()
            tri_eq = torch.equal(ktri, rtri)
            t_eq = torch.equal(kt, rt)
            err = float((kt - rt).abs().max())
            max_abs_err = max(max_abs_err, err)
            log(f"K1 vs plain [{name}]: tris {tv.shape[0]} entries "
                f"{b.num_entries} tri_equal {tri_eq} t_bitwise_equal {t_eq} "
                f"max_abs_err {err} hit_rate "
                f"{float((ktri >= 0).float().mean())}")
            if not (tri_eq and t_eq):
                raise RuntimeError(f"kernel and plain version disagree on "
                                   f"{name}")
        kernel_ms = cuda_ms(lambda: k1.bin_intersect(*ops), KERNEL_REPS)
        plain_ms = cuda_ms(lambda: k1.bin_intersect_reference(*ops),
                           PLAIN_REPS)
    log(f"K1 at the headline shapes ({rays.shape[0]} tiles x "
        f"{rays.shape[1]} rays, {b.num_entries} entries, chunk {chunk}): "
        f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms ({smi})")
    del rays, b, kt, ktri, rt, rtri
    phase_done(2)

    # ---- 3. serve frames through the port's entry point ----
    tris = Triangles.from_vertices(headline_tv, device=dev)
    frames = []
    for i in range(N_FRAMES):
        pose = Pose(from_axis_angle([0.0, 1.0, 0.0], math.radians(2.0 * i),
                                    device=dev), torch.zeros(3, device=dev))
        cam = Camera.create(RES_W, RES_H, pos=[0.002 * i, 0.0, -3.0],
                            look_at=[0.0, 0.0, 0.0], up=[0.0, 1.0, 0.0],
                            film_h=0.024, focal=0.055, device=dev)
        frames.append((Scene([SceneObject(tris, pose)]), cam))
    k1.bin_intersect.launches = 0
    outs, frame_ms = [], []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for scene, cam in frames:
        start.record()
        out = render(scene, cam, cfg)
        end.record()
        torch.cuda.synchronize()
        frame_ms.append(start.elapsed_time(end))
        outs.append(out)
    launches = k1.bin_intersect.launches
    for i, ((scene, cam), out) in enumerate(zip(frames, outs)):
        with torch.inference_mode():
            _, b = bin_object(scene.objects[0].pose.inv_apply(cam.pos), tris,
                              cam.projection().transformed(
                                  scene.objects[0].pose), cfg, RES_H, RES_W)
        hit = out.hit_tri >= 0
        log(f"frame {i}: {frame_ms[i]:.3f} ms entries {b.num_entries} "
            f"hit_rate {float(hit.float().mean()):.6f}")
        if out.image.shape != (RES_H, RES_W, 3) or out.image.dtype != \
                torch.uint8:
            raise RuntimeError(f"frame {i}: image {tuple(out.image.shape)} "
                               f"{out.image.dtype}")
        for f in ("radiance", "hit_t", "normal", "point"):
            if not bool(torch.isfinite(getattr(out, f)).all()):
                raise RuntimeError(f"frame {i}: non-finite {f}")
        if float(hit.float().mean()) < 0.5:      # the mesh fills the view
            raise RuntimeError(f"frame {i}: hit rate below 0.5")
    log(f"frames: median {float(np.median(frame_ms)):.3f} ms, first "
        f"{frame_ms[0]:.3f} ms; bin_intersect launches {launches} ({smi})")
    if launches < N_FRAMES:
        raise RuntimeError(f"bin_intersect launched {launches} times for "
                           f"{N_FRAMES} frames")
    phase_done(3)

    # ---- 4. frame 0 against the oracle on sampled rays ----
    scene, cam = frames[0]
    with torch.inference_mode():
        rmd = cam.ray_directions()
        idx = np.random.default_rng(0).choice(rmd.shape[0], N_SAMPLE,
                                              replace=False)
        idx_t = torch.from_numpy(idx).to(dev)
        ref = trace_rays(scene, cam.pos, rmd[idx_t],
                         RenderConfig(method="fixed", chunk=16384))
        got_tri = outs[0].hit_tri.reshape(-1)[idx_t]
        got_t = outs[0].hit_t.reshape(-1)[idx_t]
    agree = float((got_tri == ref.tri).float().mean())
    mism = (got_tri != ref.tri).nonzero().squeeze(1)
    rel = ((got_t[mism] - ref.t[mism]).abs() / ref.t[mism]).tolist()
    log(f"oracle agreement {agree:.6f} on {N_SAMPLE} rays; mismatches "
        f"{mism.numel()} with |dt|/t {rel}")
    if agree < MIN_AGREE:
        raise RuntimeError(f"agreement {agree} < {MIN_AGREE}")
    phase_done(4)

    # ---- 5. K2 against its plain version on the card ----
    from cpp_cuda_raytracer_dev_torch import render_differentiable
    from cpp_cuda_raytracer_dev_torch.accel.traverse import intersect_binned
    from cpp_cuda_raytracer_dev_torch.ops import gather as gather_mod
    from cpp_cuda_raytracer_dev_torch.ops.cuda import segment_sum as k2
    from cpp_cuda_raytracer_dev_torch.parallel.render_pjit import (
        make_loss_fn, make_train_step)

    target = outs[0].radiance.clone()        # frame 0's image, a plain tensor
    train_tris = Triangles.from_vertices(headline_tv, device=dev)
    train_pose = Pose(from_axis_angle([0.0, 1.0, 0.0], math.radians(1.0),
                                      device=dev), torch.zeros(3, device=dev))
    train_cam = Camera.create(RES_W, RES_H, pos=[0.0, 0.0, -3.0],
                              look_at=[0.0, 0.0, 0.0], up=[0.0, 1.0, 0.0],
                              film_h=0.024, focal=0.055,
                              device=dev).requires_grad_()
    params = {"scene": Scene([SceneObject(train_tris, train_pose)]),
              "camera": train_cam}
    all_params = [*params["scene"].parameters(), *train_cam.parameters()]

    captured = []
    segment_sum_rows = gather_mod.segment_sum_rows

    def capture(block, idx, t_rows):
        captured.append((block.detach().clone(), idx.clone(), t_rows))
        return segment_sum_rows(block, idx, t_rows)

    gather_mod.segment_sum_rows = capture    # the first step's cotangent
    try:
        make_loss_fn(cfg)(params, target).backward()
    finally:
        gather_mod.segment_sum_rows = segment_sum_rows
    for p in all_params:
        p.grad = None
    (ct, ct_idx, t_rows), = captured
    log(f"headline cotangent block {tuple(ct.shape)}, T = {t_rows}, "
        f"rows on triangle 0: {int((ct_idx == 0).sum())}")

    def k2_cases():
        rng = np.random.default_rng(0)
        long_idx = np.concatenate([np.zeros(ct.shape[0] // 2, np.int64),
                                   rng.integers(1, t_rows, ct.shape[0] // 2)])
        for name, idx, t in (
                ("random R, T", rng.integers(0, 60_000, 100_000), 60_000),
                ("every row on one id", np.full(200_000, 7), 1000),
                ("R under one run", rng.integers(0, 1000, 300), 1000),
                ("T not a multiple", rng.integers(0, 77_773, 99_991),
                 77_773),
                ("empty segments", rng.choice(np.arange(0, 90_000, 9),
                                              50_000), 90_001),
                ("headline size, half the rows on id 0", long_idx, t_rows)):
            idx = torch.from_numpy(np.sort(idx).astype(np.int32)).to(dev)
            block = torch.from_numpy(rng.standard_normal(
                (idx.shape[0], 12)).astype(np.float32)).to(dev)
            yield name, block, idx, t
            # integers in [-16, 16]: every partial sum is below 2^24, so
            # float32 sums them exactly in any order
            yield name + ", integer rows", torch.round(block * 4), idx, t
        srt, order = torch.sort(ct_idx, stable=True)
        yield ("headline cotangent", ct.index_select(0, order).contiguous(),
               srt.to(torch.int32), t_rows)

    k2_err = 0.0
    for name, block, idx, t in k2_cases():
        got = k2.segment_sum(block, idx, t)
        again = k2.segment_sum(block, idx, t)
        plain = k2.segment_sum_reference(block, idx, t)
        torch.cuda.synchronize()
        il = idx.long()
        exact = torch.zeros((t, 12), dtype=torch.float64,
                            device=dev).index_add_(0, il, block.double())
        mag = torch.zeros_like(exact).index_add_(0, il, block.abs().double())
        n_seg = torch.bincount(il, minlength=t)[:, None]
        bound = n_seg * 2.0 ** -23 * mag
        ratio = max(float(((x.double() - exact).abs() - bound).max())
                    for x in (got, plain))
        # the error as a share of sum|x|, on the longest segment
        longest = int(n_seg.argmax())
        rel = float((got[longest].double() - exact[longest]).abs().max()
                    / mag[longest].max().clamp_min(1e-300))
        err = float((got - plain).abs().max())
        k2_err = max(k2_err, err)
        integer = name.endswith("integer rows")
        exact_eq = (torch.equal(got, exact.float())
                    and torch.equal(plain, exact.float()))
        log(f"K2 vs plain [{name}]: R {block.shape[0]} T {t} max_abs_err "
            f"{err} max(|x - exact| - bound) {ratio} longest segment "
            f"{int(n_seg[longest])} rows, |x - exact| / sum|x| {rel} "
            f"bitwise_repeat {torch.equal(got, again)}"
            + (f" exact {exact_eq}" if integer else ""))
        if ratio > 0 or not torch.equal(got, again) or (integer and
                                                        not exact_eq):
            raise RuntimeError(f"segment sum out of bound, not "
                               f"deterministic or not exact on {name}")
    ct_sorted, idx_sorted = block, idx       # the headline case, last
    k2_ms = cuda_ms(lambda: k2.segment_sum(ct_sorted, idx_sorted, t_rows),
                    KERNEL_REPS)
    k2_plain_ms = cuda_ms(lambda: k2.segment_sum_reference(
        ct_sorted, idx_sorted, t_rows), KERNEL_REPS)
    ct_idx_l = ct_idx.long()
    k2_library_ms = cuda_ms(lambda: torch.zeros(
        (t_rows, 12), device=dev).index_add_(0, ct_idx_l, ct), KERNEL_REPS)
    k2_backward_ms = cuda_ms(lambda: segment_sum_rows(ct, ct_idx, t_rows),
                             KERNEL_REPS)
    k2_bytes = ct.shape[0] * (12 + 1) * 4 + t_rows * 12 * 4
    k2_bound_ms = k2_bytes / HBM_BYTES_PER_S * 1e3
    log(f"K2 at the headline cotangent: kernel {k2_ms:.4f} ms, plain "
        f"{k2_plain_ms:.4f} ms, index_add_ on unsorted rows "
        f"{k2_library_ms:.4f} ms, whole gather backward (sort + permute + "
        f"kernel) {k2_backward_ms:.4f} ms, bound {k2_bound_ms:.4f} ms "
        f"({k2_bytes} bytes) ({smi})")
    del captured, ct_sorted, idx_sorted, block, idx, got, again, plain
    phase_done(5)

    # ---- 6. training at the headline size ----
    w = torch.linspace(0.3, 1.7, RES_H * RES_W * 3,
                       device=dev).reshape(RES_H, RES_W, 3)
    start.record()
    torch.mean(render_differentiable(params["scene"], train_cam,
                                     cfg).radiance * w).backward()
    end.record()
    torch.cuda.synchronize()
    log(f"bench loss gradient (all leaves): {start.elapsed_time(end):.3f} ms")
    names = [n for n, _ in params["scene"].named_parameters()] + [
        "camera." + n for n, _ in train_cam.named_parameters()]
    for n, p in zip(names, all_params):
        if p.grad is None or not bool(torch.isfinite(p.grad).all()):
            raise RuntimeError(f"gradient of {n} missing or not finite")
    table_max = max(float(getattr(train_tris, f).grad.abs().max())
                    for f in ("p1x", "e1y", "e2z", "color"))
    log(f"gradients finite for {len(names)} leaves; max |table grad| "
        f"{table_max}; |d/d light_pos| "
        f"{params['scene'].phong.light_pos.grad.tolist()}; |d/d cam pos| "
        f"{train_cam.pos.grad.tolist()}")
    if table_max == 0:
        raise RuntimeError("every triangle-table gradient is 0")

    def run_steps(optimizer, n):
        step = make_train_step(optimizer, cfg)
        losses, ms = [], []
        for _ in range(n):
            start.record()
            loss = step(params, target)
            end.record()
            torch.cuda.synchronize()
            losses.append(float(loss))
            ms.append(start.elapsed_time(end))
        return losses, ms

    def split_and_profile(optimizer, kind, step_ms):
        """One more step split by CUDA events into forward (loss),
        backward and SGD, then one profiled step (`device_profile`)."""
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        optimizer.zero_grad(set_to_none=True)
        ev[0].record()
        loss = make_loss_fn(cfg)(params, target)
        ev[1].record()
        loss.backward()
        ev[2].record()
        optimizer.step()
        ev[3].record()
        torch.cuda.synchronize()
        split = [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
        step = make_train_step(optimizer, cfg)
        busy_ms, n_ops, top = device_profile(lambda: step(params, target))
        log(f"{kind} step split: forward {split[0]:.3f} ms, backward "
            f"{split[1]:.3f} ms, SGD {split[2]:.3f} ms; profiled step: "
            f"device busy {busy_ms:.3f} ms, {n_ops} device operations, idle "
            f"share against the median timed step (derived) "
            f"{1 - busy_ms / float(np.median(step_ms)):.3f}; top device "
            f"ms: {top}")

    opt = torch.optim.SGD(all_params, lr=LR)
    k1.bin_intersect.launches = 0
    k2.segment_sum.launches = 0
    losses, step_ms = run_steps(opt, N_TRAIN_STEPS)
    train_k1, train_k2 = (k1.bin_intersect.launches,
                          k2.segment_sum.launches)
    log(f"train steps (all leaves): ms {step_ms} losses {losses}; "
        f"bin_intersect launches {train_k1}, segment_sum launches "
        f"{train_k2} ({smi})")
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError("loss not finite")
    for n, p in zip(names, all_params):
        if not bool(torch.isfinite(p.grad).all()):
            raise RuntimeError(f"gradient of {n} not finite")
    if train_k1 < N_TRAIN_STEPS or train_k2 < N_TRAIN_STEPS:
        raise RuntimeError("a training step did not launch both kernels")
    split_and_profile(opt, "all-leaves", step_ms)
    phase_done(6)

    # ---- 7. the pose/light/camera-only step ----
    train_tris.requires_grad_(False)
    train_cam.requires_grad_(False)
    train_cam.pos.requires_grad_(True)
    opt = torch.optim.SGD([*train_pose.parameters(),
                           *params["scene"].phong.parameters(),
                           train_cam.pos], lr=LR)
    k1.bin_intersect.launches = 0
    k2.segment_sum.launches = 0
    pose_losses, pose_ms = run_steps(opt, N_POSE_STEPS)
    pose_k1, pose_k2 = k1.bin_intersect.launches, k2.segment_sum.launches
    log(f"pose/light/camera-only steps: ms {pose_ms} losses {pose_losses}; "
        f"bin_intersect launches {pose_k1}, segment_sum launches {pose_k2}")
    if pose_k2 != 0 or pose_k1 < N_POSE_STEPS:
        raise RuntimeError("the pose/light/camera-only step launched the "
                           "segment sum, or not the bin intersect")
    if not all(math.isfinite(x) for x in pose_losses):
        raise RuntimeError("loss not finite")
    split_and_profile(opt, "pose/light/camera-only", pose_ms)
    del params, opt, train_tris, all_params
    phase_done(7)

    # ---- 8. telemetry (K3) on frame 0 ----
    scene, cam = frames[0]
    obj = scene.objects[0]
    stats_cfgs = {e: dataclasses.replace(cfg, with_stats=True, bin_esub=e)
                  for e in (1, 4)}
    with torch.inference_mode():
        o_obj = obj.pose.inv_apply(cam.pos)
        proj = cam.projection().transformed(obj.pose)

        def binned(c):
            return intersect_binned(o_obj, None, obj.tris, proj, c, RES_H,
                                    RES_W)
        k1.bin_intersect.telemetry_launches = 0
        stats = {e: binned(c) for e, c in stats_cfgs.items()}
        k3_launches = k1.bin_intersect.telemetry_launches
        if k3_launches < len(stats_cfgs):
            raise RuntimeError(f"the telemetry frames launched K3 "
                               f"{k3_launches} times")
        hit1, st1 = stats[1]
        hit4, st4 = stats[4]
        same_t = torch.equal(hit1.t.reshape(RES_H, RES_W), outs[0].hit_t)
        same_tri = torch.equal(hit1.tri.reshape(RES_H, RES_W),
                               outs[0].hit_tri)
        agree4 = float((hit4.tri == hit1.tri).float().mean())
        for e, (_, st) in stats.items():
            log(f"stats esub {e}: entries {st['entries']} overflow "
                f"{st['overflow']} cross {int(st['cross'])} steps mean "
                f"{float(st['steps'].float().mean())} sum "
                f"{int(st['steps'].sum())}; chunks mean "
                f"{float(st['chunks'].float().mean())} sum "
                f"{int(st['chunks'].sum())}")
        log(f"esub 1 with stats == phase 3 frame 0: t {same_t} tri "
            f"{same_tri}; esub 4 tri agreement with esub 1 {agree4}")
        if not (same_t and same_tri):
            raise RuntimeError("the telemetry switch changed K1's hits")
        frame_stats_ms = cuda_ms(lambda: binned(stats_cfgs[1]), PLAIN_REPS)
        frame_plain_ms = cuda_ms(lambda: binned(cfg), PLAIN_REPS)
        rays, b = bin_object(o_obj, obj.tris, proj, cfg, RES_H, RES_W)
        ops = (rays, b.geom, b.entry_tri, b.starts, chunk)
        k1_ms = cuda_ms(lambda: k1.bin_intersect(*ops), KERNEL_REPS)
        k3_ms = cuda_ms(lambda: k1.bin_intersect(*ops, with_steps=True),
                        KERNEL_REPS)
        k3_esub4_ms = cuda_ms(lambda: k1.bin_intersect(
            *ops, esub=4, with_steps=True), KERNEL_REPS)
        k3_plain_ms = cuda_ms(lambda: k1.bin_intersect_reference(
            *ops, with_steps=True), PLAIN_REPS)
        # K3 against its plain version on the headline operands, before its
        # counts feed K1's bound: t, tri and steps bitwise equal, and the
        # same t and tri without the steps output
        k3_err = 0.0
        for e in (1, 4):
            got = k1.bin_intersect(*ops, esub=e, with_steps=True)
            want = k1.bin_intersect_reference(*ops, esub=e, with_steps=True)
            bare = k1.bin_intersect(*ops, esub=e)
            torch.cuda.synchronize()
            eq = [torch.equal(x, y) for x, y in zip(got, want)] + [
                torch.equal(x, y) for x, y in zip(bare, want)]
            k3_err = max(k3_err, float((got[0] - want[0]).abs().max()))
            log(f"K3 vs plain [headline frame 0, esub {e}]: t {eq[0]} tri "
                f"{eq[1]} steps {eq[2]}; without steps: t {eq[3]} tri "
                f"{eq[4]}")
            if not all(eq):
                raise RuntimeError(f"K3 and its plain version disagree at "
                                   f"esub {e}")
            if e == 1:
                steps = got[2]
        if not torch.equal(steps[:, 0], st1["steps"]):
            raise RuntimeError("kernel steps differ from the frame's")
        n_tiles, p = rays.shape[:2]
        pairs = int(steps[:, 0].sum()) * chunk * p
        k1_bytes = (rays.numel() * 4 + b.geom.numel() * 4
                    + b.entry_tri.numel() * 4 + b.starts.numel() * 4
                    + n_tiles * p * 8)
    k1_ops_ms = (pairs * K1_OPS_PER_PAIR
                 / (N_SMS * FP32_LANES * 2 * clock_mhz * 1e6) * 1e3)
    k1_bytes_ms = k1_bytes / HBM_BYTES_PER_S * 1e3
    k1_bound_ms = max(k1_ops_ms, k1_bytes_ms)
    k1_bound_by = "operations" if k1_ops_ms >= k1_bytes_ms else "bytes"
    log(f"K1 scanned {pairs} ray-entry pairs ({int(steps[:, 0].sum())} "
        f"blocks x {chunk} x {p}); bound {k1_bound_ms:.4f} ms (operations "
        f"{k1_ops_ms:.4f} ms at {K1_OPS_PER_PAIR} FP32 ops a pair and "
        f"{clock_mhz} MHz, bytes {k1_bytes_ms:.4f} ms); kernel "
        f"{k1_ms:.4f} ms, with steps {k3_ms:.4f} ms, esub 4 with steps "
        f"{k3_esub4_ms:.4f} ms, plain with steps {k3_plain_ms:.4f} ms; "
        f"intersect_binned with stats {frame_stats_ms:.4f} ms, without "
        f"{frame_plain_ms:.4f} ms ({smi})")
    phase_done(8)

    # ---- 9. the cluster paths (K4, K5) ----
    cluster_kernels = run_cluster_paths(dev, headline_tv, frames, idx_t, ref,
                                        smi, clock_mhz)
    phase_done(9)

    # ---- 10. the per-tile bin kernel K6 ----
    k6_kernel = run_bin_tile(dev, frames, idx_t, ref, cfg, smi, clock_mhz)
    phase_done(10)

    # ---- 11. the entry points: render_cli and animate ----
    run_entry_points(dev, headline_tv, smi)
    phase_done(11)

    print(json.dumps({"kernels": [{
        "name": "bin_intersect", "route": "cuda",
        "source": "cpp_cuda_raytracer_dev_torch/csrc/bin_intersect.cu",
        "replaces": "cpp_cuda_raytracer_dev_tpu/ops/pallas/bin_kernel3.py:43",
        "launches": launches, "max_abs_err": max_abs_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": k1_bound_ms,
        "bound_by": k1_bound_by, "library_ms": None,
        "launches_by_path": {"serve": launches, "train": train_k1,
                             "train_pose_light_camera": pose_k1}}, {
        "name": "bin_intersect_telemetry", "route": "cuda",
        "source": "cpp_cuda_raytracer_dev_torch/csrc/bin_intersect.cu",
        "replaces": "cpp_cuda_raytracer_dev_tpu/ops/pallas/bin_kernel2.py:62",
        "launches": k3_launches, "max_abs_err": k3_err,
        "ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": k1_bound_ms,
        "bound_by": k1_bound_by, "library_ms": None,
        "ms_without_steps": k1_ms, "ms_esub4": k3_esub4_ms,
        "launches_by_path": {"stats_frames": k3_launches}}, {
        "name": "segment_sum", "route": "cuda",
        "source": "cpp_cuda_raytracer_dev_torch/csrc/segment_sum.cu",
        "replaces": "cpp_cuda_raytracer_dev_tpu/ops/gather.py:71",
        "launches": train_k2, "max_abs_err": k2_err,
        "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound_ms,
        "bound_by": "bytes", "library_ms": k2_library_ms,
        "backward_ms": k2_backward_ms,
        "launches_by_path": {"serve": 0, "train": train_k2,
                             "train_pose_light_camera": pose_k2}},
        *cluster_kernels, k6_kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def run_cluster_paths(dev, headline_tv, frames, idx_t, ref, smi, clock_mhz):
    """Phase 9 (see the module docstring): the cluster paths at the
    headline size. Returns the kernels line's entries for K4 and K5."""
    from cpp_cuda_raytracer_dev_torch import (Camera, ClusterAccel, Pose,
                                              RenderConfig, Scene,
                                              SceneObject, Triangles, render)
    from cpp_cuda_raytracer_dev_torch.accel import traverse as tr
    from cpp_cuda_raytracer_dev_torch.ops.cuda import segment_sum as k2
    from cpp_cuda_raytracer_dev_torch.ops.cuda import tile_intersect as k45
    from cpp_cuda_raytracer_dev_torch.ops.quaternion import from_axis_angle
    from cpp_cuda_raytracer_dev_torch.parallel.render_pjit import \
        make_train_step
    from cpp_cuda_raytracer_dev_torch.utils.procgen import uv_sphere

    cfgs = {"pallas2": RenderConfig(
        method="pallas2", leaf_size=128, tile_h=16, tile_w=32,
        max_candidates=64, group_size=32, max_groups=24, escalate_tiles=64,
        escalate_factor=4)}
    cfgs["pallas"] = dataclasses.replace(cfgs["pallas2"], method="pallas")
    c2 = cfgs["pallas2"]
    kernels = {"K4": (k45.tile_intersect_v2, k45.tile_intersect_v2_reference),
               "K5": (k45.tile_intersect, k45.tile_intersect_reference)}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    tris = frames[0][0].objects[0].tris
    t0 = time.perf_counter()
    accel = ClusterAccel.build(tris, leaf_size=c2.leaf_size, cache=False)
    torch.cuda.synchronize()
    fill = (accel.slot_mat >= 0).sum(dim=1).float()
    log(f"ClusterAccel: {accel.num_clusters} clusters of at most "
        f"{int(fill.max())} triangles (mean {float(fill.mean()):.2f}), "
        f"{accel.geom9.shape[2]} slots, built in "
        f"{time.perf_counter() - t0:.2f} s")
    n_slots = accel.slot_mat.shape[1]

    def camera(pos, w, h):
        return Camera.create(w, h, pos=list(pos), look_at=[0.0, 0.0, 0.0],
                             up=[0.0, 1.0, 0.0], film_h=0.024, focal=0.055,
                             device=dev)

    def operands(scene, cam, acc, c, res_w, res_h):
        """The kernels' operands for the first pass and the escalation
        pass of a pallas2 frame (intersect_clustered_pallas_v2's steps)."""
        obj = scene.objects[0]
        o = obj.pose.inv_apply(cam.pos)
        d = obj.pose.inv_apply_vec(cam.ray_directions())
        k = min(c.max_candidates, acc.num_clusters)
        tiles, _ = tr._tile_rays(d, res_h, res_w, c.tile_h, c.tile_w)
        cand, count, ovf = tr._cull(o, tiles, acc, c, k)
        root = torch.cat([o, acc.bounds_min.amin(dim=0),
                          acc.bounds_max.amax(dim=0)])
        first = (tiles.transpose(1, 2).contiguous(), cand, count,
                 tr._candidate_boxes(o, acc, cand, count), root, acc.geom9,
                 acc.slot_mat)
        etile = torch.sort(ovf, descending=True,
                           stable=True).indices[:c.escalate_tiles]
        et = tiles[etile]
        cand2, count2, ovf2 = tr.cull_tiles(
            o, et, acc, c.tile_h, c.tile_w,
            min(k * c.escalate_factor, acc.num_clusters))
        second = (et.transpose(1, 2).contiguous(), cand2, count2,
                  tr._candidate_boxes(o, acc, cand2, count2), root,
                  acc.geom9, acc.slot_mat)
        return first, second, ovf, ovf2

    # kernels against their plain versions on identical operands
    sphere_tris = Triangles.from_vertices(uv_sphere(50, 50), device=dev)
    cases = [
        ("sphere 96x64", Scene([SceneObject(sphere_tris)]),
         camera((0.0, 0.0, -3.0), 96, 64),
         ClusterAccel.build(sphere_tris, leaf_size=128, cache=False), c2, 96,
         64),
        ("dragon-class frame 0", *frames[0], accel, c2, RES_W, RES_H),
        ("dragon-class grazing, 4 candidates", Scene([SceneObject(tris)]),
         camera((1.8, 0.3, 1.6), RES_W, RES_H), accel,
         dataclasses.replace(c2, max_candidates=4), RES_W, RES_H)]
    max_err = {"K4": 0.0, "K5": 0.0}
    with torch.inference_mode():
        for name, scene, cam, acc, c, w, h in cases:
            first, second, ovf, ovf2 = operands(scene, cam, acc, c, w, h)
            log(f"cluster operands [{name}]: {first[0].shape[0]} tiles, "
                f"K {first[1].shape[1]}, count mean "
                f"{float(first[2].float().mean()):.2f}, overflow tiles "
                f"{int((ovf > 0).sum())} (max {int(ovf.max())}); escalation "
                f"pass {second[0].shape[0]} tiles at K {second[1].shape[1]}, "
                f"overflow left on {int((ovf2 > 0).sum())}")
            if name == "dragon-class frame 0":
                frame0 = first
            for kname, (fn, plain) in kernels.items():
                for pname, ops in (("first pass", first),
                                   ("escalation pass", second)):
                    got = fn(*ops)
                    torch.cuda.synchronize()
                    want = plain(*ops)
                    torch.cuda.synchronize()
                    eq = [torch.equal(x, y) for x, y in zip(got, want)]
                    err = float((got[0] - want[0]).abs().max())
                    max_err[kname] = max(max_err[kname], err)
                    log(f"{kname} vs plain [{name}, {pname}]: t_bitwise_equal "
                        f"{eq[0]} tri_equal {eq[1]} steps_equal {eq[2]} "
                        f"max_abs_err {err} hit_rate "
                        f"{float((got[1] >= 0).float().mean()):.6f} "
                        f"candidates visited {int(got[2][:, 0].sum())}")
                    if not all(eq):
                        raise RuntimeError(f"{kname} and its plain version "
                                           f"disagree on {name}, {pname}")
        ms = {}
        for kname, (fn, plain) in kernels.items():
            ms[kname] = (cuda_ms(lambda: fn(*frame0), KERNEL_REPS),
                         cuda_ms(lambda: plain(*frame0), PLAIN_REPS))
            log(f"{kname} at headline frame 0 ({frame0[0].shape[0]} tiles x "
                f"{frame0[0].shape[2]} rays, K {frame0[1].shape[1]}): kernel "
                f"{ms[kname][0]:.4f} ms, plain {ms[kname][1]:.4f} ms ({smi})")

    # serve frames through the entry point, one path at a time
    served, launches = {}, {}
    for method, n in N_CLUSTER_FRAMES.items():
        k45.tile_intersect_v2.launches = 0
        k45.tile_intersect.launches = 0
        frame_ms, outs = [], []
        for scene, cam in frames[:n]:
            start.record()
            out = render(scene, cam, cfgs[method], accel=(accel,))
            end.record()
            torch.cuda.synchronize()
            frame_ms.append(start.elapsed_time(end))
            outs.append(out)
        launches[method] = (k45.tile_intersect_v2.launches,
                            k45.tile_intersect.launches)
        served[method] = outs
        for i, out in enumerate(outs):
            hit = out.hit_tri >= 0
            if out.image.shape != (RES_H, RES_W, 3) or not all(
                    bool(torch.isfinite(getattr(out, f)).all())
                    for f in ("radiance", "hit_t", "normal", "point")):
                raise RuntimeError(f"{method} frame {i}: bad shape or "
                                   "non-finite output")
            if float(hit.float().mean()) < 0.5:
                raise RuntimeError(f"{method} frame {i}: hit rate below 0.5")
        log(f"{method} frames: ms {[round(x, 3) for x in frame_ms]}, median "
            f"{float(np.median(frame_ms)):.3f} ms; K4 launches "
            f"{launches[method][0]}, K5 launches {launches[method][1]} "
            f"({smi})")
        busy_ms, n_ops, top = device_profile(
            lambda: render(*frames[0], cfgs[method], accel=(accel,)))
        log(f"{method} profiled frame: device busy {busy_ms:.3f} ms, {n_ops} "
            f"device operations, idle share against the median frame "
            f"(derived) {1 - busy_ms / float(np.median(frame_ms)):.3f}; top "
            f"device ms: {top}")
    if launches["pallas2"][0] < N_CLUSTER_FRAMES["pallas2"] or \
            launches["pallas2"][1] != 0:
        raise RuntimeError(f"pallas2 frames launched K4/K5 "
                           f"{launches['pallas2']} times")
    if launches["pallas"][1] < N_CLUSTER_FRAMES["pallas"] or \
            launches["pallas"][0] != 0:
        raise RuntimeError(f"pallas frames launched K4/K5 "
                           f"{launches['pallas']} times")

    # frame 0 of each method, and one grid frame, against the oracle rays
    with torch.inference_mode():
        scene, cam = frames[0]
        start.record()
        grid_out = render(scene, cam, dataclasses.replace(c2, method="grid"),
                          accel=(accel,))
        end.record()
        torch.cuda.synchronize()
        log(f"grid frame 0: {start.elapsed_time(end):.3f} ms")
        agree = {}
        for method, out in (("pallas2", served["pallas2"][0]),
                            ("pallas", served["pallas"][0]),
                            ("grid", grid_out)):
            got_tri = out.hit_tri.reshape(-1)[idx_t]
            got_t = out.hit_t.reshape(-1)[idx_t]
            agree[method] = float((got_tri == ref.tri).float().mean())
            mism = (got_tri != ref.tri).nonzero().squeeze(1)
            rel = ((got_t[mism] - ref.t[mism]).abs() / ref.t[mism]).tolist()
            log(f"{method} frame 0 oracle agreement {agree[method]:.6f} on "
                f"{N_SAMPLE} rays; mismatches {mism.numel()} with |dt|/t "
                f"{rel}")
        same = float((served["pallas2"][0].hit_tri
                      == served["pallas"][0].hit_tri).float().mean())
        log(f"pallas2 vs pallas frame 0: hit ids equal on {same:.6f}")
    if min(agree.values()) < MIN_AGREE:
        raise RuntimeError(f"cluster-path oracle agreement {agree}")

    # one pallas2 training step from a pose turned by 1 degree
    target = served["pallas2"][0].radiance.clone()
    ttris = Triangles.from_vertices(headline_tv, device=dev)
    tpose = Pose(from_axis_angle([0.0, 1.0, 0.0], math.radians(1.0),
                                 device=dev), torch.zeros(3, device=dev))
    tcam = camera((0.0, 0.0, -3.0), RES_W, RES_H).requires_grad_()
    params = {"scene": Scene([SceneObject(ttris, tpose)]), "camera": tcam}
    leaves = [*params["scene"].named_parameters(),
              *(("camera." + n, p) for n, p in tcam.named_parameters())]
    opt = torch.optim.SGD([p for _, p in leaves], lr=LR)
    step = make_train_step(opt, c2, accel=(accel,))
    k45.tile_intersect_v2.launches = 0
    k2.segment_sum.launches = 0
    start.record()
    loss = float(step(params, target))
    end.record()
    torch.cuda.synchronize()
    train_k4 = k45.tile_intersect_v2.launches
    train_k2 = k2.segment_sum.launches
    log(f"pallas2 training step: {start.elapsed_time(end):.3f} ms, loss "
        f"{loss}, K4 launches {train_k4}, segment_sum launches {train_k2} "
        f"({smi})")
    bad = [n for n, p in leaves
           if p.grad is None or not bool(torch.isfinite(p.grad).all())]
    if bad or not math.isfinite(loss) or train_k4 < 1 or train_k2 < 1:
        raise RuntimeError(f"pallas2 training step: non-finite or missing "
                           f"gradients {bad}, or a kernel did not launch")
    del params, opt, step, leaves, ttris

    # telemetry of frame 0: one sub-tile per ray counts the rays that pass
    # each box test; sub-tiles never change a hit
    with torch.inference_mode():
        scene, cam = frames[0]
        obj = scene.objects[0]
        hit_s, st = tr.intersect_clustered_pallas_v2(
            obj.pose.inv_apply(cam.pos),
            obj.pose.inv_apply_vec(cam.ray_directions()), accel,
            dataclasses.replace(c2, with_stats=True, debug_mode=1, sub_h=1,
                                sub_w=1), RES_H, RES_W)
        out0 = served["pallas2"][0]
        if not (torch.equal(hit_s.t, out0.hit_t.reshape(-1))
                and torch.equal(hit_s.tri, out0.hit_tri.reshape(-1))):
            raise RuntimeError("the telemetry changed K4's hits")
        p = frame0[0].shape[2]
        tele = {k: fn(*frame0, n_sub=p, count_subs=True)[2]
                for k, (fn, _) in kernels.items()}
        if not torch.equal(tele["K4"], torch.stack([st["steps"],
                                                    st["mt_subs"]], 1)):
            raise RuntimeError("K4's telemetry differs from the frame's")
        ovf = st["overflow"]
        log(f"pallas2 frame 0 stats: candidates visited mean "
            f"{float(st['steps'].float().mean()):.3f} (count mean "
            f"{float(st['count'].float().mean()):.3f}), rays past a box test "
            f"{int(st['mt_subs'].sum())}, residual overflow tiles "
            f"{int((ovf > 0).sum())} max {int(ovf.max())}")
        # the work the function needs: each ray past a candidate's box test
        # against that cluster's triangles, not its padding slots. A walk cut
        # to its first k candidates takes the same steps up to k, so the
        # ray counts at count = min(count, k) for k = 0..K differ by the rays
        # past each candidate's box test
        cand_l = frame0[1].long().clamp_min(0)
        tri_fill = (accel.slot_mat >= 0).sum(dim=1)[cand_l]      # (nT, K)
        entries = {}
        for kname, ops_pair in (("K4", K4_OPS_PER_PAIR),
                                ("K5", K5_OPS_PER_PAIR)):
            fn = kernels[kname][0]
            past = torch.stack([fn(
                *frame0[:2], frame0[2].clamp_max(k), *frame0[3:], n_sub=p,
                count_subs=True)[2][:, 1] for k in range(
                    frame0[1].shape[1] + 1)], dim=1)
            if not torch.equal(past[:, -1], tele[kname][:, 1]):
                raise RuntimeError(f"{kname}'s cut walks disagree with its "
                                   "telemetry")
            rays_k = past.diff(dim=1).long()                     # (nT, K)
            pairs = int((rays_k * tri_fill).sum())
            read = frame0[1][rays_k > 0].long().unique()
            read_tris = int((accel.slot_mat[read] >= 0).sum())
            n_t = frame0[0].shape[0]
            nbytes = (sum(x.numel() for x in frame0[:5]) * 4
                      + read_tris * 10 * 4 + n_t * (p * 8 + 8))
            ops_ms = (pairs * ops_pair
                      / (N_SMS * FP32_LANES * 2 * clock_mhz * 1e6) * 1e3)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            log(f"{kname} on frame 0: {pairs} (ray, triangle) pairs past the "
                f"box test ({int(tele[kname][:, 1].sum())} rays x "
                f"{pairs / max(1, int(tele[kname][:, 1].sum())):.2f} "
                f"triangles; {int(tele[kname][:, 1].sum()) * n_slots} with "
                f"the {n_slots} slots), {read.numel()} clusters of "
                f"{read_tris} triangles read; bound "
                f"{max(ops_ms, bytes_ms):.4f} ms (operations {ops_ms:.4f} ms "
                f"at {ops_pair} FP32 ops a pair and {clock_mhz} MHz, bytes "
                f"{bytes_ms:.4f} ms); kernel {ms[kname][0]:.4f} ms ({smi})")
            entries[kname] = (max(ops_ms, bytes_ms),
                              "operations" if ops_ms >= bytes_ms else "bytes")

    return [{
        "name": "tile_intersect_v2", "route": "cuda",
        "source": "cpp_cuda_raytracer_dev_torch/csrc/tile_intersect.cu",
        "replaces": "cpp_cuda_raytracer_dev_tpu/ops/pallas/"
                    "intersect_kernel_v2.py:58",
        "launches": launches["pallas2"][0], "max_abs_err": max_err["K4"],
        "ms": ms["K4"][0], "plain_ms": ms["K4"][1],
        "bound_ms": entries["K4"][0], "bound_by": entries["K4"][1],
        "library_ms": None,
        "launches_by_path": {"serve_pallas2": launches["pallas2"][0],
                             "serve_pallas": launches["pallas"][0],
                             "train_pallas2": train_k4}}, {
        "name": "tile_intersect", "route": "cuda",
        "source": "cpp_cuda_raytracer_dev_torch/csrc/tile_intersect.cu",
        "replaces": "cpp_cuda_raytracer_dev_tpu/ops/pallas/"
                    "intersect_kernel.py:55",
        "launches": launches["pallas"][1], "max_abs_err": max_err["K5"],
        "ms": ms["K5"][0], "plain_ms": ms["K5"][1],
        "bound_ms": entries["K5"][0], "bound_by": entries["K5"][1],
        "library_ms": None,
        "launches_by_path": {"serve_pallas2": launches["pallas2"][1],
                             "serve_pallas": launches["pallas"][1],
                             "train_pallas2": 0}}]


def run_bin_tile(dev, frames, idx_t, ref, cfg, smi, clock_mhz):
    """Phase 10 (see the module docstring): kernel K6 on the port's own
    binning. Returns the kernels line's entry for K6."""
    from cpp_cuda_raytracer_dev_torch import (Camera, Scene, SceneObject,
                                              Triangles)
    from cpp_cuda_raytracer_dev_torch.accel import traverse as tr
    from cpp_cuda_raytracer_dev_torch.ops.cuda import bin_intersect as k1
    from cpp_cuda_raytracer_dev_torch.ops.cuda import bin_tile_intersect as bt
    from cpp_cuda_raytracer_dev_torch.ops.intersect import (FixedOriginCache,
                                                            mt_fixed_origin)
    from cpp_cuda_raytracer_dev_torch.utils.procgen import uv_sphere

    chunk = K6_CHUNK
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def operands(scene, cam, c, w, h):
        """(object-frame origin, ray table, BinnedScene, K6's operands)."""
        obj = scene.objects[0]
        o = obj.pose.inv_apply(cam.pos)
        rays, b = tr.bin_object(o, obj.tris,
                                cam.projection().transformed(obj.pose), c, h,
                                w)
        return o, rays, b, bt.tile_operands(rays, b, obj.tris, o, chunk)

    def decode(enc, b):
        return bt.decode_enc(enc, b.starts, b.entry_tri, chunk)

    with torch.inference_mode():
        # K6's own entry point (binning -> operands -> kernel -> decoded ids)
        # on each of phase 3's frames, with the launch counter from 0
        bt.bin_tile_intersect.launches = 0
        path_ms, path_out = [], []
        for scene, cam in frames:
            start.record()
            _, _, b, ops = operands(scene, cam, cfg, RES_W, RES_H)
            t6, enc6, _ = bt.bin_tile_intersect(*ops, chunk=chunk)
            tri6 = decode(enc6, b)
            end.record()
            torch.cuda.synchronize()
            path_ms.append(start.elapsed_time(end))
            path_out.append(tri6)
        launches = bt.bin_tile_intersect.launches
        log(f"K6 path (binning, operands, kernel, decode) on {len(frames)} "
            f"frames: ms {[round(x, 3) for x in path_ms]}; "
            f"bin_tile_intersect launches {launches} ({smi})")
        if launches < len(frames):
            raise RuntimeError(f"bin_tile_intersect launched {launches} times "
                               f"for {len(frames)} frames")

        # the kernel against its plain version, every debug mode
        sphere = Triangles.from_vertices(uv_sphere(50, 50), device=dev)
        sphere_cam = Camera.create(96, 64, pos=[0.0, 0.0, -3.0],
                                   look_at=[0.0, 0.0, 0.0],
                                   up=[0.0, 1.0, 0.0], film_h=0.024,
                                   focal=0.055, device=dev)
        cases = [("sphere 96x64", Scene([SceneObject(sphere)]), sphere_cam,
                  dataclasses.replace(cfg, backface_cull=False), 96, 64),
                 ("dragon-class frame 0", *frames[0], cfg, RES_W, RES_H)]
        max_err = 0.0
        for name, scene, cam, c, w, h in cases:
            o, rays, b, ops = operands(scene, cam, c, w, h)
            base = None
            for mode in (0, 1, 2):
                got = bt.bin_tile_intersect(*ops, chunk=chunk,
                                            debug_mode=mode)
                torch.cuda.synchronize()
                want = bt.bin_tile_intersect_reference(*ops, chunk=chunk,
                                                       debug_mode=mode)
                torch.cuda.synchronize()
                eq = [torch.equal(x, y) for x, y in zip(got, want)]
                ids_eq = torch.equal(decode(got[1], b), decode(want[1], b))
                err = float((got[0] - want[0]).abs().max())
                max_err = max(max_err, err)
                same_hits = base is None or (torch.equal(got[0], base[0])
                                             and torch.equal(got[1], base[1]))
                log(f"K6 vs plain [{name}, debug_mode {mode}]: "
                    f"t_bitwise_equal {eq[0]} enc_equal {eq[1]} steps_equal {eq[2]} ids_equal "
                    f"{ids_eq} max_abs_err {err} same hits as mode 0 "
                    f"{same_hits}; chunks walked {int(got[2][:, 0].sum())} of "
                    f"{int(got[2][:, 1].sum())}, hit_rate "
                    f"{float((got[1] >= 0).float().mean()):.6f}")
                if not (all(eq) and ids_eq and same_hits):
                    raise RuntimeError(f"K6 and its plain version disagree on "
                                       f"{name}, debug_mode {mode}")
                if mode == 0:
                    base = got
        # the last case is frame 0: its operands and mode-0 result stay
        t6, enc6, steps6 = base
        tri6 = decode(enc6, b)
        if not torch.equal(tri6, path_out[0]):
            raise RuntimeError("K6's frame 0 differs from its path run")

        # K6 against K1 on frame 0: the same entry constants, so the same t;
        # ids may differ only where two triangles tie
        t1, tri1 = k1.bin_intersect(rays, b.geom, b.entry_tri, b.starts,
                                    cfg.bin_chunk)
        differ = tri6 != tri1
        n_diff = int(differ.sum())
        log(f"K6 vs K1 on frame 0: t bitwise equal {torch.equal(t6, t1)}, "
            f"ids differ on {n_diff} of {tri6.numel()} rays")
        if n_diff:
            d = rays[..., :3][differ]
            cache = FixedOriginCache.build(o, frames[0][0].objects[0].tris)
            orc = mt_fixed_origin(d, cache, cfg.draw_distance, cfg.eps,
                                  chunk=16384)

            def t_of(ids):   # each id's t by the oracle's constants
                ids = ids.long()
                return cache.tdet[ids] / (d * cache.m_det[ids]).sum(dim=1)
            ta, tb = t_of(tri6[differ]), t_of(tri1[differ])
            rel = torch.maximum((ta - orc.t).abs(), (tb - orc.t).abs()) / orc.t
            where = differ.nonzero().tolist()
            rows = zip(where, tri6[differ].tolist(), ta.tolist(),
                       tri1[differ].tolist(), tb.tolist(), orc.tri.tolist(),
                       orc.t.tolist(), rel.tolist())
            for (tile, ray), a, t_a, b1, t_b, ot, o_t, r in rows:
                log(f"  tile {tile} ray {ray}: K6 triangle {a} t {t_a!r}, K1 "
                    f"triangle {b1} t {t_b!r}, oracle triangle {ot} t "
                    f"{o_t!r}, |dt|/t {r}")
            if bool((orc.tri < 0).any()) or float(rel.max()) > 1e-5:
                raise RuntimeError("K6 and K1 differ where the oracle sees no "
                                   "tie")

        # frame 0 against phase 4's oracle rays
        img_tri = tr._untile(tri6, tr._bin_meta(cfg, RES_H, RES_W), RES_H,
                             RES_W).reshape(-1)
        agree = float((img_tri[idx_t] == ref.tri).float().mean())
        log(f"K6 frame 0 oracle agreement {agree:.6f} on {N_SAMPLE} rays")
        if agree < MIN_AGREE:
            raise RuntimeError(f"K6 oracle agreement {agree} < {MIN_AGREE}")

        kernel_ms = cuda_ms(lambda: bt.bin_tile_intersect(*ops, chunk=chunk),
                            KERNEL_REPS)
        plain_ms = cuda_ms(lambda: bt.bin_tile_intersect_reference(
            *ops, chunk=chunk), PLAIN_REPS)
        # the bound: the pairs of the chunks whose gate opened, and every
        # walked chunk's entry constants
        gated = bt.gated_chunks(*ops, chunk=chunk)
        walked = steps6[:, 0]
        if bool((gated > walked).any()):
            raise RuntimeError("more gated chunks than walked ones")
        n_t, _, p = ops[0].shape
        pairs = int(gated.sum()) * chunk * p
        entries = int(walked.sum()) * chunk
        nbytes = ((ops[0].numel() + ops[1].numel() + ops[2].numel()) * 4
                  + entries * bt.ROWS * 4 + n_t * (p * 8 + 8))
    ops_ms = ((pairs * K6_OPS_PER_PAIR + entries * K6_OPS_PER_ENTRY)
              / (N_SMS * FP32_LANES * 2 * clock_mhz * 1e6) * 1e3)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"K6 at headline frame 0 ({n_t} tiles x {p} rays, chunk {chunk}): "
        f"chunks in range {int(steps6[:, 1].sum())}, walked "
        f"{int(walked.sum())}, gate open {int(gated.sum())}; {pairs} "
        f"ray-entry pairs; bound {max(ops_ms, bytes_ms):.4f} ms (operations "
        f"{ops_ms:.4f} ms at {K6_OPS_PER_PAIR} FP32 ops a pair and "
        f"{K6_OPS_PER_ENTRY} an entry constant, {clock_mhz} MHz; bytes "
        f"{bytes_ms:.4f} ms, {nbytes} bytes); kernel {kernel_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms ({smi})")
    return {
        "name": "bin_tile_intersect", "route": "cuda",
        "source": "cpp_cuda_raytracer_dev_torch/csrc/bin_tile_intersect.cu",
        "replaces": "cpp_cuda_raytracer_dev_tpu/ops/pallas/bin_kernel.py:42",
        "launches": launches, "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
        "launches_by_path": {"bin_tile_frames": launches}}


def write_ply(path, tv: np.ndarray) -> None:
    """``tv`` (T, 3, 3) as a binary little-endian PLY: 3T vertices and T
    faces (p2, p3, p1), which the reader's rewind to (p3, p1, p2) turns back
    into the triangles as given."""
    n = tv.shape[0]
    faces = np.empty(n, dtype=[("n", "u1"), ("i", "<i4", (3,))])
    faces["n"] = 3
    base = 3 * np.arange(n, dtype=np.int32)[:, None]
    faces["i"] = base + np.array([1, 2, 0], np.int32)
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {3 * n}\nproperty float x\nproperty float y\n"
              f"property float z\nelement face {n}\n"
              "property list uchar int vertex_indices\nend_header\n")
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(np.ascontiguousarray(tv, "<f4").tobytes())
        f.write(faces.tobytes())


def read_png(path) -> np.ndarray:
    """(H, W, 3) uint8, top row first, of a PNG that ``write_png`` wrote
    (8-bit RGB, filter 0 on every row)."""
    import struct
    import zlib
    data = open(path, "rb").read()
    pos, idat = 8, b""
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    if (raw[:, 0] != 0).any():
        raise RuntimeError(f"{path}: a row filter other than 0")
    return raw[:, 1:].reshape(h, w, 3)


def run_entry_points(dev, headline_tv, smi):
    """Phase 11 (see the module docstring): the apps on the headline mesh,
    written to a PLY file."""
    import contextlib
    from pathlib import Path

    from cpp_cuda_raytracer_dev_torch import (Camera, RenderConfig, Scene,
                                              SceneObject, Triangles)
    from cpp_cuda_raytracer_dev_torch.apps import animate, render_cli
    from cpp_cuda_raytracer_dev_torch.models.renderer import trace_rays
    from cpp_cuda_raytracer_dev_torch.ops.cuda import bin_intersect as k1
    from cpp_cuda_raytracer_dev_torch.ops.cuda import bin_tile_intersect as bt
    from cpp_cuda_raytracer_dev_torch.ops.cuda import segment_sum as k2
    from cpp_cuda_raytracer_dev_torch.ops.cuda import tile_intersect as k45

    out_dir = Path(__file__).resolve().parent / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    mesh = out_dir / "dragon_class.ply"
    t0 = time.perf_counter()
    write_ply(mesh, headline_tv)
    log(f"wrote {mesh.name} ({mesh.stat().st_size} bytes) in "
        f"{time.perf_counter() - t0:.2f} s")
    counters = {"K1": k1.bin_intersect, "K2": k2.segment_sum,
                "K4": k45.tile_intersect_v2, "K5": k45.tile_intersect,
                "K6": bt.bin_tile_intersect}

    # the apps' camera (render_cli.py): framed on the mesh's bounding box
    v = headline_tv.reshape(-1, 3)
    lo, hi = v.min(0), v.max(0)
    center, size = (lo + hi) / 2, float(np.linalg.norm(hi - lo))
    scene = Scene([SceneObject(Triangles.from_vertices(headline_tv,
                                                       device=dev))])
    oracle_cfg = RenderConfig(method="fixed", chunk=16384,
                              draw_distance=max(400.0, 10 * size))
    kernel_of = {"bin": "K1", "pallas2": "K4", "kd": None}
    for method, (w, h) in (("bin", (RES_W, RES_H)),
                           ("pallas2", (RES_W, RES_H)), ("kd", KD_RES)):
        png = out_dir / f"render_cli_{method}.png"
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        render_cli.main(["--mesh", str(mesh), "--out", str(png), "--res",
                         str(w), str(h), "--method", method])
        secs = time.perf_counter() - t0
        launched = {k: fn.launches for k, fn in counters.items()}
        # the PNG (top row first) against the oracle on sampled rays
        img = read_png(png)[::-1].reshape(-1, 3)
        cam = Camera.create(w, h, pos=center + np.array(
            [0, 0.1 * size, -1.2 * size]), look_at=center, up=[0, 1, 0],
            film_h=0.024, focal=0.055, device=dev)
        with torch.inference_mode():
            rmd = cam.ray_directions()
            idx = np.random.default_rng(0).choice(w * h, N_SAMPLE,
                                                  replace=False)
            orc = trace_rays(scene, cam.pos,
                             rmd[torch.from_numpy(idx).to(dev)], oracle_cfg)
        png_hit = (img[idx] != np.array(BACKGROUND, np.uint8)).any(axis=1)
        orc_hit = (orc.tri >= 0).cpu().numpy()
        agree = float((png_hit == orc_hit).mean())
        log(f"render_cli --method {method} at {w}x{h}: {secs:.2f} s in all; "
            f"PNG hit rate {float(png_hit.mean()):.6f} against the oracle's "
            f"{float(orc_hit.mean()):.6f} on {N_SAMPLE} rays, hit/miss "
            f"agreement {agree:.6f}; launches {launched} ({smi})")
        want = kernel_of[method]
        if agree < MIN_AGREE:
            raise RuntimeError(f"render_cli {method}: PNG and oracle agree on "
                               f"{agree}")
        if want is not None and launched[want] < 1:
            raise RuntimeError(f"render_cli {method} did not launch {want}")

    # animate: the key script on two objects sharing one Triangles
    report = out_dir / "animate.json"
    hud = out_dir / "animate_hud.txt"
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with open(hud, "w") as f, contextlib.redirect_stdout(f):
        animate.main(["--mesh", str(mesh), "--res", str(RES_W), str(RES_H),
                      "--frames", str(N_ANIMATE_TICKS), "--second-object",
                      "--method", "bin", "--json-out", str(report)])
    secs = time.perf_counter() - t0
    k1_launches = k1.bin_intersect.launches
    rep = json.loads(report.read_text())
    log(f"animate --second-object --method bin at {RES_W}x{RES_H}: "
        f"{rep['frames']} ticks in {secs:.2f} s in all, objects "
        f"{rep['objects']}, device ms a frame {rep['device_ms_per_frame']!r} "
        f"(animate's device_time), bin_intersect launches {k1_launches}; "
        f"HUD in {hud.name} ({smi})")
    if (rep["frames"] != N_ANIMATE_TICKS or rep["objects"] != 2
            or k1_launches < 2 * N_ANIMATE_TICKS):
        raise RuntimeError("animate did not render its ticks through K1 "
                           "twice a frame")


if __name__ == "__main__":
    main()
