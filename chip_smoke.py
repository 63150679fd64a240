#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's ``method="bin"`` frame (its set-up through kernel K11,
its prepass through K8 and K9, its shading through K10) and its training
step, the
cluster paths ``method="pallas2"`` and ``"pallas"``, the per-tile bin
kernel K6, the apps ``render_cli`` and ``animate``, the sharded entry points
(at world size 1 over NCCL), the raster path, float64, the compiled
frame and step (``render_jit``, ``make_train_step_jit``) and the KD path
``method="kd"`` (kernel K7), at the headline size:
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
  2. the bin-intersect kernel K1 against its plain PyTorch version on the
     same binned tensors (a 96x64 sphere and the headline frame): triangle
     ids equal and t bitwise equal; on headline frame 0 against the JAX
     kernels' walk over whole blocks (K3's esub-1 instance, the aligned
     walk): t bitwise equal, every differing id printed and required to be
     a tie by the mt_fixed_origin oracle; the two walks timed in turns
     (aligned walk, K1, K1 with the tiles in index order, the same again,
     K1, aligned walk) and the plain version once, with CUDA events; the
     pairs K1's gate let through, and the pairs its test accepted, give
     its bounds;
  3. serve 8 frames at distinct camera positions and object poses through
     ``render``, each timed with CUDA events, after resetting the kernel's
     launch counter; the counter must show the frames went through it;
     then 8 frames with K1 and 8 with the aligned walk in its place, in turns,
     and one profiled frame of each (device busy ms and operations);
  4. frame 0 against the ``mt_fixed_origin`` oracle on 4,096 sampled rays
     (seed 0): agreement >= 0.999;
  5. the segment-sum kernel (K2), reading the rows through their sort
     order, against its plain version on the card, on synthetic cases (one
     at the headline size with half the rows on one id), each with its rows
     shuffled and the permutation as the order, and on the cotangent block
     of the first headline training step with its sort order: within
     n·2⁻²³·Σ|x| of a float64 sum per id, two launches bitwise equal; each
     synthetic case again on integer rows, whose sums float32 holds
     exactly, where both must equal the float64 sum bitwise (a dropped or
     doubled run of a long segment fails there); the headline cotangent
     once more with its rows permuted beforehand (no order): the same sums
     bitwise; timed beside the plain version, autograd's default backward
     (``index_add_`` on the unsorted rows), the stable sort alone and the
     whole gather backward (sort + kernel); the kernel's call and the
     backward, beside the backward that permutes the rows first (sort +
     permute + kernel on sorted rows), profiled for their device busy time;
  6. training: the bench's weighted-radiance gradient over every scene and
     camera leaf (finite, table gradients not all 0), then 5
     ``make_train_step`` steps with SGD(lr 1e-4) toward frame 0's image from
     a pose turned by 1 degree, each timed with CUDA events; both kernels'
     counters are reset just before the steps and must show >= 5 launches;
     then one step split into forward, backward and SGD, and one profiled
     step (device busy ms and device operations); then 4 steps with these
     kernels and 4 with the aligned walk and the permuting backward in
     their place, in turns;
  7. the pose/light/camera-only step (triangle tables frozen), 3 steps: the
     segment-sum counter must not move; split and profiled as in 6;
  8. telemetry (kernel K3): frame 0 through ``intersect_binned`` with
     ``with_stats`` at esub 1 (phase 3's t bitwise, and every id that
     differs from phase 3's an oracle tie) and esub 4; the kernel against
     its plain version on a 96x64 sphere, a sphere whose every triangle is
     there twice (every hit an exact tie between two ids) and frame 0's
     operands, at esub 1, 2 and 4, with and without steps (t, tri and
     steps bitwise equal; without steps at esub 1 that is K1's walk); the
     design and each lever switched off timed in turns
     (``time_variants``), esub 4 and the plain version timed; the
     ray-entry pairs K3 scanned, and those accepted, give its bound at K1's
     count; the frame timed with and without the telemetry;
  9. the cluster paths: build the ClusterAccel (seconds, clusters), which
     must go through the native KD builder, then the native builder
     against the numpy one on the same boxes (seconds each, trees bitwise
     equal); the
     tile-intersect kernels K4 and K5 against their plain versions on the
     same operands (a 96x64 sphere, headline frame 0, a grazing view
     with 4 candidates a tile whose overflow forces escalation, and a
     sphere whose every triangle is there twice, so that every hit is an
     exact tie: the first pass and the escalation pass, each with and
     without the sub-tile count), ids, t and steps bitwise equal, and on
     the tie scene the tie rule's winner; the lane efficiency one ray a
     thread would have on frame 0 (from the telemetry); both kernels, and
     K4's escalation pass, timed with CUDA events; each design lever
     switched off in turn and timed against the design (``time_levers``);
     the cull kernel K14 against its plain twin on headline frame 0 (the
     two-level first pass and a flat pass of 256 tiles at 128 candidates,
     the ``pallas2.orbit`` bucket: ids, counts, overflow and boxes
     bitwise), each pass and its twin timed, with its bound;
     8 "pallas2" and 3 "pallas" frames through ``render``
     at phase 3's cameras and poses after resetting both launch counters,
     which must show the frames went through the kernels; frame 0 of each
     and one "grid" frame against phase 4's oracle rays (agreement >=
     0.999); one profiled frame of each path (device busy ms, device
     operations); one "pallas2" training step (every gradient finite); the
     telemetry of frame 0 (candidates visited, rays that passed each box
     test, residual overflow); each candidate's rays past its box test,
     times its cluster's triangle count, give both kernels' bounds and the
     escalation pass's (``pair_count``);
 10. the per-tile bin kernel K6 at chunk 128 on the port's own binning:
     its entry point (bin_object -> tile_operands -> kernel -> decode_enc)
     on phase 3's 8 frames after resetting its launch counter, which must
     show them; the kernel against its plain version on the 96x64 sphere,
     the duplicated-triangle tie scene and headline frame 0 at n_sub 1, 2
     and 16 and debug_mode 0, 1 and 2 (t bitwise, enc, steps and decoded
     ids equal; the same hits in every mode); its decoded ids against K1's
     on frame 0, as phase 2 holds K1 against the aligned walk; agreement
     with phase 4's oracle rays >= 0.999; the design and each lever
     switched off timed in turns, the plain version timed; the chunks
     whose gate opened and the walked chunks' constants give its bound;
 11. the entry points: the headline mesh written as a binary PLY under
     build/chip_smoke/, then ``render_cli.main`` with ``--method bin``,
     ``pallas2`` and ``kd`` (leaf 128) at 960x540, each PNG's hit/miss
     against the oracle on 4,096 sampled rays of the same camera
     (agreement >= 0.999) and each path's kernel counter moved (K1, K4,
     K7; the apps render through ``render_jit``: the counter sees the
     capture); then ``animate.main`` for 30 ticks at
     960x540 with ``--second-object --method bin --json-out``, profiled:
     two objects, K1 twice a frame, which the profiler must show;
 12. sharding, in this process at world size 1 over NCCL (a sharded phase
     never falls back to gloo or the CPU): meshes (1,) and (1, 1);
     ``render_sharded`` with ``bin``, ``pallas2`` and ``pallas``,
     ``render_sharded_2d_bin`` and ``render_sharded_2d_accel`` (``pallas2``)
     on frame 0 at the headline size, each bit for bit ``render``'s frame
     (t, ids, object ids, image, radiance, normal, point) with its kernels'
     launch counters reset just before and required to move
     (K1, K4, K5); ``render_sharded_2d`` (the brute ``fixed`` path, about
     4e11 ray-triangle pairs at the headline) on a cut mesh of
     ``SHARDED_2D_TRIS`` triangles at 960x540, against ``render`` with
     ``fixed``; one sharded all-leaves ``make_train_step`` step against the
     single-device step from the same parameters: K1's and K2's counters
     move, every gradient finite, gradients and parameters bitwise equal;
     then the compiled sharded paths: an NCCL all-reduce and all-gather
     captured by the capture cache's own ``capture`` and replayed on new
     inputs, bitwise (the compiled frame and step skip their collectives at
     world size 1); ``render_sharded_jit`` on frames 0, 1, 0 for ``bin``,
     ``pallas2``, ``pallas`` and ``kd`` (leaf 128), each bitwise
     ``render_sharded``'s, one graph a method, eager and replayed frames in
     turns, profiled, each kernel seen inside the replay; the compiled
     all-leaves and pose/light/camera-only sharded bin steps
     (``make_train_step_jit`` with the mesh) against eager sharded steps
     from twin parameter sets: parameters bitwise after 3 steps and after
     8 of each in turns and a profiled one (medians, device busy ms, host
     operations), K1 (and K2, all leaves only) seen in the replayed step;
     ranks on several cards are chip_sharded.py's;
 13. the raster path (plain PyTorch, no kernel) on headline frame 0:
     ``RASTER_FRAMES`` frames timed with CUDA events, the peak memory above
     the scene, the overflow stats (nothing dropped), ids against K1's frame
     (every difference an oracle tie or a ray where the raster id is the
     oracle's and K1's is not, ROADMAP F2) and agreement with phase 4's
     oracle rays >= 0.999; one frame each at ``RASTER_SPANS``;
 14. float64 on the card: ``brute`` and ``fixed`` frames of a 1,152-triangle
     sphere in float64 (float64 outputs, finite, ids equal to float32's on
     >= 98% of pixels), the analytic ray (|t - 3| <= 1e-12), a finite
     float64 gradient of the mean radiance with respect to the camera
     position, and ``bin`` and ``raster`` refusing float64;
 15. ``render_jit`` (a captured CUDA graph a frame) on headline frames 0, 1
     and 0 for ``bin``, ``pallas2`` and ``pallas``, each bit for bit
     ``render``'s (t, ids, object ids, image, radiance, normal, point), one
     graph captured a method; eager and replayed frames timed in turns
     (CUDA events, medians and spread) and one of each profiled (device
     busy ms, device operations, host operations = the host's CUDA runtime
     calls, and K1, K4 and K5 seen by kernel name inside the replay); a
     camera moved nearer until its live entry count outgrows frame 0's
     bucket: captured again and still bitwise; the compiled all-leaves and
     pose/light/camera-only steps (``make_train_step_jit``) against the
     eager steps from twin parameter sets: parameters bitwise equal after
     3 steps and again after the timed ones, K1 (and K2, all leaves only)
     seen in the replayed step, step ms in turns. A capture that fails
     fails the run: nothing falls back to the eager frame;
 16. the KD path: the KD traversal kernel K7 against its plain version
     (``kd_traverse_reference``, with the near-first exit), t and ids
     bitwise, and K7 with the exit switched off against the walk without
     it (``near_first=False``), and the two walks against each other, on a
     96x64 sphere and a sphere whose every triangle is there twice (every
     hit an exact tie) at leaf sizes 1, 8 and 128, and on axis-aligned rays
     through the split planes of a height field on exact binary fractions
     (a zero direction component on a box plane: NaN in the slab test) at
     leaf sizes 1, 4 and 128, and on rays grazing two tilted planes (1e-4
     and 1e-3 radians in float32, 1e-12 and 1e-10 in float64, where MT's t
     loses its digits) at leaf sizes 1 and 8, each in float32 and float64
     (and at 1e-5 radians, below the exit's proven bound, where the rays
     on which the two walks differ are counted, not held);
     then on headline
     frame 0 at 960x540, leaf 128, every ray, in float32 and (the same rays
     widened) float64 (the plain version in runs of ``KD_PLAIN_CHUNK``,
     timed once, with its counts); K7 timed with CUDA events in both; the
     slab tests, MT pairs and skipped pops that those plain walks count,
     with and without the exit, give its bounds (float64 at the FP64
     rate); each design lever switched off against the design, in turns,
     in both dtypes; 8 kd frames through
     ``render`` after resetting K7's counter, which must show them, frame
     0's ids those of the bitwise run and agreement with phase 4's oracle
     rays >= 0.999; ``render_jit`` kd frames 0, 1, 0 bitwise ``render``'s,
     one graph, K7 seen in the replay, eager and replayed frames in turns;
     the compiled kd all-leaves and pose/light/camera-only steps bitwise the
     eager ones, as phase 15's; ``make_train_step_jit`` with raster, which
     runs uncaptured (``make_train_step``'s step), ``N_RASTER_STEPS`` steps
     bitwise the eager ones;
 17. the serving frame's kernels K8 (the bin prepass's per-triangle pass
     and its ray table), K9 (the entry passes around the key sort), K10
     (shading and composition) and K11 (the frame's set-up: rays,
     Projections, object frames): K8 and K9 bitwise their plain versions
     (every output of each launch) on a 96x64 sphere, headline frame 0 at
     the live count and at bucket 524,288, the band of its rows 270-539 and
     each object of a two-object scene sharing the headline Triangles;
     K10 bitwise its plain version on the sphere, frame 0, the band, the
     two-object scene and the kd frame 0 in float64; K11 (through
     ``set_up_frame``) bitwise its plain version ``frame_setup_reference``
     (every ray, origin and Projection field) on headline frame 0 for bin
     and kd in float32 and kd in float64, the band of its rows 270-539,
     the bin probe (no rays) and the two-object scene (bin, raster, and a
     fixed band); each launch timed (its device time from the profiler)
     against its plain version and its byte bound; the replayed bin
     frame's device time by stage (each stage captured alone: set-up, ray
     table, prepass, sort, table, K1, shading and composition) with the
     kernels and with the plain versions; replayed
     bin, ``pallas2``, ``pallas`` and kd frames and the compiled
     all-leaves and pose/light/camera-only steps with the kernels and with
     the plain versions in their places, in turns, bitwise, one of each
     profiled (device busy, device and host operations, kernels seen: K8
     and K9 in every bin frame and step, K10 in every frame and step, K12
     in every step, K11 in every frame and step and K13 in every step; the
     plain route runs K11's plain version and the steps K10's, K12's and
     K13's twins; K11's counter moves in the captures with the kernels and
     not on the plain route, whose replays show no K11); the counters from
     0 over 8 bin frames through ``render``, a ``pallas2`` and a
     ``pallas`` frame, and one bin training step (K10, K11, K12 and K13
     once). Phases 11 and 12 count K8-K12 on the apps and sharded paths;
 18. the training shading's backward K12 (``models/shade_grad.py``, the
     autograd Function whose forward is K10): K12 bitwise its plain twin
     ``shade_grad_reference`` (partials, constants, the rays', tables' and
     hit t's cotangents) at headline frame 0 with the training loss's
     radiance cotangent (the pose/light/camera and the all-leaves steps'
     calls) and with random cotangents of radiance, normal and point; each
     step's call timed (its device time from the profiler) against its
     twin and its byte bound; the compiled pose/light/camera-only and
     all-leaves steps (``make_train_step_jit``) with K12 and with its twin
     in its place, in turns, losses and parameters bitwise, one of each
     profiled, and the counters (K10's, K11's, K12's and K13's launches).
     K12's row of the kernels line
     takes its ``launches`` from phase 17's eager bin step (counter at 0
     before it); the log prints the process's totals. Then the training
     set-up's backward K13 (``models/camera.py``'s autograd Function whose
     forward is K11): bitwise its plain twin ``frame_setup_grad_reference``
     at headline frame 0 with the rays' cotangent K12 writes for the
     pose/light/camera step, in float32 and float64 and on the band of rows
     270-539; its two launches timed (device time from the profiler)
     against its byte bound, and the call (both launches and the sum
     between them) and its twin each captured alone.
A differing id passes as a tie when both triangles' t, by the oracle's
constants, lie within 1e-5 of the oracle's t. Each phase prints its seconds.
Operation bounds are given at the FMA peak (``bound_ms``: 2 operations a
lane a clock) and at one instruction an operation (``bound_issue_ms``: the
kernels are built with -fmad=false). Prints a JSON line of per-kernel
results (``launches_by_path`` with phase 12's sharded paths, its
``sharded_jit`` and ``sharded_train_jit``, and phase 15's ``serve_jit`` and
``train_jit``: kernel instances the profiler saw in one replayed frame or
step, as a replay moves no launch counter), then, as the
last line,
``{"ok": true, "device": {...}}``. Needs a CUDA device and never falls back
to the CPU.
"""

from __future__ import annotations

import dataclasses
import itertools
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
N_PAIRED = 8                   # frames or steps of each kind, in turns
LR = 1e-4
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
N_SMS, FP32_LANES = 132, 128   # per SM; FMA peak = SMs x lanes x 2 x clock
FP64_LANES = 64                # per SM (H100 SXM data sheet: 34 TFLOP/s FP64)
K1_OPS_PER_PAIR = 29           # csrc/bin_intersect.cu, "Bound"
K1_OPS_PER_ACCEPTED = 3        # K1's select and division, accepted pairs
K4_OPS_PER_PAIR = 29           # csrc/tile_intersect.cu, "Bound"
K5_OPS_PER_PAIR = 26
K6_OPS_PER_PAIR = 29           # csrc/bin_tile_intersect.cu, "Bound"
K6_OPS_PER_ENTRY = 52          # its constants (51) and depth minimum, a chunk
K6_CHUNK = 128
KD_LEAF = 128                  # render_cli's default leaf size
KD_PLAIN_CHUNK = 131072        # rays a run of K7's plain version
K7_OPS_PER_NODE = 36           # csrc/kd_traverse.cu, "Bound"
K7_OPS_PER_PAIR = 54
K7_LEVER_ROUNDS = 4            # rounds of K7's levers in turns (ABBA)
K7_LEVER_REPS = 5              # launches a timed sample
K8_OPS_PER_TRI = 150           # csrc/bin_prepass.cu, "Bound"
RAY_TABLE_OPS_PER_RAY = 60
K9_OPS_PER_TRI = 30
K9_OPS_PER_ENTRY = 12
K10_OPS_PER_HIT = 240          # csrc/shade.cu, "Bound"
K11_OPS_PER_RAY = 25           # csrc/shade.cu, K11's "Bound"
K11_OPS_PER_OBJECT_RAY = 15
K12_OPS_PER_HIT = 400          # csrc/shade.cu, K12's "Bound"
K13_OPS_PER_RAY = 45           # csrc/shade.cu, K13's "Bound"
K14_OPS_PER_TEST = 30          # csrc/tile_intersect.cu, K14's "Bound": a box
#                                test's 6 differences and 4 planes of 6
K14_BUCKET = (256, 128)        # pallas2.orbit's escalation bucket
N_RASTER_STEPS = 2             # uncaptured compiled raster steps vs eager
N_ANIMATE_TICKS = 30
BACKGROUND = (240, 130, 0)
N_CLUSTER_FRAMES = {"pallas2": 8, "pallas": 3}
SHARDED_2D_TRIS = 20_000       # render_sharded_2d (brute) at a cut size
RASTER_FRAMES = 3
RASTER_SPANS = (8, 16)         # timed once each against the default 4
N_JIT_STEPS = 3                # compiled against eager steps, bitwise
PROFILE_PAD_S = 0.005          # idle host time either side of a profiled call
LEAD_KERNELS = 100             # spin kernels that open a profiled window,
LEAD_GAP_S = 0.001             # this far apart
LEAD_NAME = "spin_kernel"      # torch.cuda._sleep's kernel
LEAD_SEEN = []                 # of each profiled window's lead-in kernels
# the wrappers of kernels K8 (two launches), K9 (two), K10 and K11
SERVING_KERNELS = ("bin_tri_pass", "ray_table", "bin_entry_keys",
                   "bin_entry_table", "shade_compose", "frame_setup")
# each kernel's name in a profiler trace (a replay has no launch counter)
KERNEL_NAMES = {"bin_intersect": "own_walk_kernel",
                "segment_sum": "segment_sum_level",
                "tile_intersect_v2": "tile_intersect_kernel<true",
                "tile_intersect": "tile_intersect_kernel<false",
                "kd_traverse": "kd_traverse_kernel",
                "bin_tri_pass": "tri_pass_kernel",
                "ray_table": "ray_table_kernel",
                "bin_entry_keys": "entry_keys_kernel",
                "bin_entry_table": "entry_table_kernel",
                "shade_compose": "shade_compose_kernel",
                "frame_setup": "frame_setup_kernel",
                "shade_grad": "shade_grad_kernel",
                "frame_setup_grad": "frame_setup_grad_kernel",
                "cluster_cull": "cluster_cull_kernel"}
# K3's and K6's design levers, each switched off (one ray a thread, which at
# P 512 is also one entry group of 512 threads; one entry group of P / 4
# threads; two rays a thread in two groups; the next block or chunk copied
# just before its use; the tiles in index order), and the CTA widened to
# eight groups (1,024 threads, one CTA an SM)
WALK_LEVERS = {"design": {}, "one_ray_a_thread": {"rays_per_thread": 1},
               "one_group": {"groups": 1},
               "two_rays_two_groups": {"rays_per_thread": 2, "groups": 2},
               "no_overlap": {"overlap": False},
               "index_order": {"longest_first": False},
               "eight_groups": {"groups": 8}}


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


def lead_in() -> None:
    """Open a profiled window with `LEAD_KERNELS` short spin kernels,
    `LEAD_GAP_S` apart, and a synchronise. Later in a long run the
    profiler drops more of the first device records of a window (two in
    phase 12: a sharded frame's K11, its first kernel, went unseen while
    the same frame in a fresh process showed it; in phase 15 all of eight
    spin kernels; in phase 17 all 20 launches of the ray table); these
    are what it drops first, by count or by time. The readers leave the
    spin kernels, and the host calls up to the synchronise, out; how
    many were seen goes to `LEAD_SEEN`. A kernel's presence in a replay
    is also held by its launch counter where it can be (K11)."""
    for _ in range(LEAD_KERNELS):
        torch.cuda._sleep(100)
        time.sleep(LEAD_GAP_S)
    torch.cuda.synchronize()


def lead_seen(events) -> None:
    """Record how many of `lead_in`'s kernels the profiler kept (and log
    it when it dropped some)."""
    kept = sum(a.count for a in events if LEAD_NAME in a.key)
    LEAD_SEEN.append(kept)
    if kept < LEAD_KERNELS:
        log(f"profiler: kept {kept} of {LEAD_KERNELS} lead-in kernels "
            f"(window {len(LEAD_SEEN)})")


def device_profile(fn):
    """Run ``fn()`` once under torch.profiler, with `PROFILE_PAD_S` of idle
    host time either side and `lead_in` before it. Returns (device busy
    ms, device operations, the 8 largest device kernels as (name, count,
    ms)). Only device events count: an aten op's own device time repeats
    its kernels'."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        lead_in()
        fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    events = [a for a in prof.key_averages()
              if a.device_type == DeviceType.CUDA]
    lead_seen(events)
    on_dev = [a for a in events if LEAD_NAME not in a.key]
    on_dev.sort(key=lambda a: -a.self_device_time_total)
    top = [(a.key[:48], a.count, a.self_device_time_total / 1e3)
           for a in on_dev[:8]]
    return (sum(a.self_device_time_total for a in on_dev) / 1e3,
            sum(a.count for a in on_dev), top)


def replay_profile(fn):
    """Run ``fn()`` once under torch.profiler. Returns (device busy ms,
    device operations, host operations, {kernel name: instances}, graph
    launches): the host operations are the CUDA runtime calls the host made
    (kernel and graph launches, copies, fills, syncs: the host's events
    named ``cuda*``), the instances count each `KERNEL_NAMES` kernel among
    the device events, a captured graph's included, and the graph launches
    are the host's ``cudaGraphLaunch`` calls; a sixth value counts the host
    operations by name (with a process group they include the polls of
    NCCL's watchdog thread). The window has `PROFILE_PAD_S` of idle host
    time either side of the call (one profiled replay once lost the first
    175 of its device records) and `lead_in` before it, whose kernels and
    host calls are left out."""
    import collections

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        lead_in()
        fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    on_host = sorted((e for e in prof.events()
                      if e.device_type == DeviceType.CPU
                      and e.name.startswith("cuda")),
                     key=lambda e: e.time_range.start)
    lead_end = next(e.time_range.end for e in on_host
                    if e.name == "cudaDeviceSynchronize")
    calls = collections.Counter(e.name for e in on_host
                                if e.time_range.start >= lead_end)
    events = [a for a in prof.key_averages()
              if a.device_type == DeviceType.CUDA]
    lead_seen(events)
    on_dev = [a for a in events if LEAD_NAME not in a.key]
    host = sum(calls.values())
    seen = {k: sum(a.count for a in on_dev if name in a.key)
            for k, name in KERNEL_NAMES.items()}
    graphs = sum(n for name, n in calls.items()
                 if name.startswith("cudaGraphLaunch"))
    return (sum(a.self_device_time_total for a in on_dev) / 1e3,
            sum(a.count for a in on_dev), host, seen, graphs, dict(calls))


def op_bounds(n_ops: int, n_bytes: int, clock_mhz: float,
              lanes: int = FP32_LANES) -> dict:
    """A kernel's least time on the card: the larger of its bytes over the
    memory rate and its operations over the FMA peak (``bound_ms``, 2
    operations a lane a clock) or over the issue rate at one instruction
    an operation (``bound_issue_ms``: the kernels are built with
    -fmad=false, so no multiply and add fuse); ``lanes`` an SM:
    `FP32_LANES`, or `FP64_LANES` for float64 operations."""
    issue_ms = n_ops / (N_SMS * lanes * clock_mhz * 1e6) * 1e3
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    fma_ms = issue_ms / 2
    return {"bound_ms": max(fma_ms, bytes_ms),
            "bound_by": "operations" if fma_ms >= bytes_ms else "bytes",
            "bound_issue_ms": max(issue_ms, bytes_ms),
            "text": f"bound {max(fma_ms, bytes_ms):.4f} ms at the FMA peak, "
                    f"{max(issue_ms, bytes_ms):.4f} ms at one instruction "
                    f"an operation (operations {fma_ms:.4f} / {issue_ms:.4f} "
                    f"ms at {lanes} lanes an SM and {clock_mhz} MHz, bytes "
                    f"{bytes_ms:.4f} ms, {n_bytes} bytes)"}


def check_ties(name_a, tri_a, name_b, tri_b, rays, o, tris, cfg) -> None:
    """Every ray on which two bin walks give different triangle ids (their
    t being bitwise equal) must be a tie by the mt_fixed_origin oracle:
    both triangles' t, by the oracle's constants, within 1e-5 of the
    oracle's t. Prints each such ray."""
    from cpp_cuda_raytracer_dev_torch.ops.intersect import (FixedOriginCache,
                                                            mt_fixed_origin)
    differ = tri_a != tri_b
    if not bool(differ.any()):
        return
    d = rays[..., :3][differ]
    cache = FixedOriginCache.build(o, tris)
    orc = mt_fixed_origin(d, cache, cfg.draw_distance, cfg.eps, chunk=16384)

    def t_of(ids):   # each id's t by the oracle's constants
        ids = ids.long()
        return cache.tdet[ids] / (d * cache.m_det[ids]).sum(dim=1)
    ta, tb = t_of(tri_a[differ]), t_of(tri_b[differ])
    rel = torch.maximum((ta - orc.t).abs(), (tb - orc.t).abs()) / orc.t
    rows = zip(differ.nonzero().tolist(), tri_a[differ].tolist(), ta.tolist(),
               tri_b[differ].tolist(), tb.tolist(), orc.tri.tolist(),
               orc.t.tolist(), rel.tolist())
    for at, a, t_a, b, t_b, ot, o_t, r in rows:
        log(f"  ray {tuple(at)}: {name_a} triangle {a} t {t_a!r}, "
            f"{name_b} triangle {b} t {t_b!r}, oracle triangle {ot} t "
            f"{o_t!r}, |dt|/t {r}")
    if bool((orc.tri < 0).any()) or float(rel.max()) > 1e-5:
        raise RuntimeError(f"{name_a} and {name_b} differ where the oracle "
                           "sees no tie")


def aligned_walk(*args, **kwargs):
    """`bin_intersect` with the walk over whole blocks, K3's esub-1 instance
    (which also writes its steps), in place of K1's walk over the tiles' own
    entries."""
    from cpp_cuda_raytracer_dev_torch.ops.cuda.bin_intersect import \
        bin_intersect
    kwargs["with_steps"] = True
    return bin_intersect(*args, **kwargs)[:2]


def permuting_backward(block, idx, t_rows):
    """The gather backward with the rows permuted into sort order first,
    then K2 on the sorted rows (no order)."""
    from cpp_cuda_raytracer_dev_torch.ops.cuda.segment_sum import segment_sum
    idx_sorted, order = torch.sort(idx, stable=True)
    return segment_sum(block.index_select(0, order).contiguous(),
                       idx_sorted.to(torch.int32), t_rows)


def in_turns(run, kinds, n):
    """{kind: [ms]}: ``run(kind, i)`` timed with CUDA events ``n`` times a
    kind, the kinds in turns (ABBA order), in one process."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    ms = {k: [] for k in kinds}
    for i in range(n):
        for kind in (kinds if i % 2 == 0 else kinds[::-1]):
            start.record()
            run(kind, i)
            end.record()
            torch.cuda.synchronize()
            ms[kind].append(start.elapsed_time(end))
    return ms


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
                         "bin_tile_intersect", "kd_traverse", "bin_prepass",
                         "shade")
    log(f"built {', '.join(lib.name for lib, _ in built.values())} in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, (_, build_log) in built.items():
        for line in build_log.splitlines():
            if "entry function" in line or "registers" in line \
                    or "spill" in line:
                log(f"  ptxas [{name}]: {line.strip()}")

    cfg = headline_configs()["bin"]
    chunk = cfg.bin_chunk
    phase_done(1)

    # ---- 2. kernel vs plain version on identical binned tensors ----
    def binned_case(tv, res_w, res_h, cull, pos=(0.0, 0.0, -3.0)):
        tris = Triangles.from_vertices(tv, device=dev)
        cam = Camera.create(res_w, res_h, pos=list(pos),
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
        # the last case is headline frame 0 (phase 3's frame 0): K1 against
        # the aligned walk over whole blocks, K3's esub-1 instance
        ops = (rays, b.geom, b.entry_tri, b.starts, chunk)
        wt, wtri, _ = k1.bin_intersect(*ops, with_steps=True)
        torch.cuda.synchronize()
        log(f"K1 vs the aligned walk (K3 at esub 1) on frame 0: t bitwise "
            f"equal "
            f"{torch.equal(kt, wt)}, ids differ on "
            f"{int((ktri != wtri).sum())} of {ktri.numel()} rays")
        if not torch.equal(kt, wt):
            raise RuntimeError("K1's t differs from the aligned walk's")
        walk_ties = int((ktri != wtri).sum())
        check_ties("K1", ktri, "aligned walk", wtri, rays,
                   torch.tensor([0.0, 0.0, -3.0], device=dev),
                   Triangles.from_vertices(headline_tv, device=dev), cfg)
        # in turns, so that the walks and K1's two tile orders are compared
        # on one card: aligned, K1, index order, index order, K1, aligned
        walks = (lambda: k1.bin_intersect(*ops, with_steps=True),
                 lambda: k1.bin_intersect(*ops),
                 lambda: k1.bin_intersect(*ops, longest_first=False))
        turns = [cuda_ms(walks[i], KERNEL_REPS) for i in (0, 1, 2, 2, 1, 0)]
        kernel_ms = (turns[1] + turns[4]) / 2
        walk_ms = (turns[0] + turns[5]) / 2
        plain_ms = cuda_ms(lambda: k1.bin_intersect_reference(*ops),
                           PLAIN_REPS)
        # the bound: each own entry of a block whose gate opened, against
        # every ray of its tile, and the select and division of the pairs
        # the test accepted
        n_tiles, p = rays.shape[:2]
        k1_entries, k1_accepted = k1.walk_work(*ops)
        k1_pairs = int(k1_entries.sum()) * p
        k1_accepted = int(k1_accepted.sum())
        k1_bytes = (rays.numel() * 4 + b.geom.numel() * 4
                    + b.entry_tri.numel() * 4 + b.starts.numel() * 4
                    + n_tiles * p * 8)
    k1_bound = op_bounds(k1_pairs * K1_OPS_PER_PAIR
                         + k1_accepted * K1_OPS_PER_ACCEPTED, k1_bytes,
                         clock_mhz)
    log(f"K1 at the headline shapes ({n_tiles} tiles x {p} rays, "
        f"{b.num_entries} entries, chunk {chunk}): kernel {turns[1]:.4f} / "
        f"{turns[4]:.4f} ms, with the tiles in index order {turns[2]:.4f} / "
        f"{turns[3]:.4f} ms, the aligned walk {turns[0]:.4f} / "
        f"{turns[5]:.4f} ms (in turns), plain {plain_ms:.4f} ms; {k1_pairs} "
        f"ray-entry pairs through the gate, {k1_accepted} of them accepted; "
        f"{k1_bound['text']} ({smi})")
    del rays, b, kt, ktri, rt, rtri, wt, wtri
    phase_done(2)

    # ---- 3. serve frames through the port's entry point ----
    frames = headline_frames(dev, headline_tv)
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
            obj = scene.objects[0]
            _, b = bin_object(obj.pose.inv_apply(cam.pos), obj.tris,
                              cam.projection().transformed(obj.pose), cfg,
                              RES_H, RES_W)
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
    # the frame with the aligned walk in K1's place, in turns with K1 in
    # this process: the own walk's effect end to end, free of the spread
    # between processes
    from cpp_cuda_raytracer_dev_torch.accel import traverse

    def paired_frame(kind, i):
        traverse.bin_intersect = (k1.bin_intersect if kind == "K1"
                                  else aligned_walk)
        render(*frames[i % N_FRAMES], cfg)
    try:
        paired = in_turns(paired_frame, ("K1", "aligned walk"), N_PAIRED)
        # the device's share, free of the host: one profiled frame each
        busy = {k: device_profile(lambda: paired_frame(k, 0))[:2]
                for k in paired}
    finally:
        traverse.bin_intersect = k1.bin_intersect
    log("frames in turns: " + "; ".join(
        f"{k} median {float(np.median(v)):.3f} ms {[round(x, 3) for x in v]}, "
        f"profiled frame: device busy {busy[k][0]:.3f} ms in {busy[k][1]} "
        f"operations" for k, v in paired.items()) + f" ({smi})")
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
        """(name, rows, sorted ids, T, order): the rows in some order and
        the permutation that reads them in id order, as the backward has
        them before its sort."""
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
            order = torch.from_numpy(rng.permutation(idx.shape[0])).to(dev)
            rows = torch.from_numpy(rng.standard_normal(
                (idx.shape[0], 12)).astype(np.float32)).to(dev)
            yield name, rows, idx, t, order
            # integers in [-16, 16]: every partial sum is below 2^24, so
            # float32 sums them exactly in any order
            yield name + ", integer rows", torch.round(rows * 4), idx, t, order
        srt, order = torch.sort(ct_idx, stable=True)
        yield "headline cotangent", ct, srt.to(torch.int32), t_rows, order

    k2_err = 0.0
    for name, rows, idx, t, order in k2_cases():
        got = k2.segment_sum(rows, idx, t, order=order)
        again = k2.segment_sum(rows, idx, t, order=order)
        plain = k2.segment_sum_reference(rows, idx, t, order=order)
        torch.cuda.synchronize()
        il = idx.long()
        block = rows.index_select(0, order)      # the rows in id order
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
        log(f"K2 vs plain [{name}]: R {rows.shape[0]} T {t} max_abs_err "
            f"{err} max(|x - exact| - bound) {ratio} longest segment "
            f"{int(n_seg[longest])} rows, |x - exact| / sum|x| {rel} "
            f"bitwise_repeat {torch.equal(got, again)}"
            + (f" exact {exact_eq}" if integer else ""))
        if ratio > 0 or not torch.equal(got, again) or (integer and
                                                        not exact_eq):
            raise RuntimeError(f"segment sum out of bound, not "
                               f"deterministic or not exact on {name}")
    # the headline case, last: its rows permuted beforehand give the same
    # sums bitwise (the same additions in the same order)
    ct_idx_sorted, ct_order = idx, order
    presorted = k2.segment_sum(block.contiguous(), idx, t_rows)
    log(f"K2 [headline cotangent, rows permuted beforehand, no order]: "
        f"bitwise equal to the fused read {torch.equal(presorted, got)}")
    if not torch.equal(presorted, got):
        raise RuntimeError("K2 differs between the fused and the presorted "
                           "rows")
    k2_ms = cuda_ms(lambda: k2.segment_sum(ct, ct_idx_sorted, t_rows,
                                           order=ct_order), KERNEL_REPS)
    k2_plain_ms = cuda_ms(lambda: k2.segment_sum_reference(
        ct, ct_idx_sorted, t_rows, order=ct_order), KERNEL_REPS)
    ct_idx_l = ct_idx.long()
    k2_library_ms = cuda_ms(lambda: torch.zeros(
        (t_rows, 12), device=dev).index_add_(0, ct_idx_l, ct), KERNEL_REPS)
    k2_sort_ms = cuda_ms(lambda: torch.sort(ct_idx, stable=True),
                         KERNEL_REPS)
    k2_backward_ms = cuda_ms(lambda: segment_sum_rows(ct, ct_idx, t_rows),
                             KERNEL_REPS)
    # back to back, the small operations of the backward (and of K2's own
    # call: zero fill, scratch, three levels) can be paced by the host; the
    # device's own time is the profile's busy time
    busy = {name: device_profile(fn)[:2] for name, fn in (
        ("K2", lambda: k2.segment_sum(ct, ct_idx_sorted, t_rows,
                                      order=ct_order)),
        ("sort + K2", lambda: segment_sum_rows(ct, ct_idx, t_rows)),
        ("sort + permute + K2 on sorted rows",
         lambda: permuting_backward(ct, ct_idx, t_rows)))}
    # rows (48 B), ids (4 B) and the int64 order (8 B) read once, the sums
    # written once
    k2_bytes = ct.shape[0] * (12 * 4 + 4 + 8) + t_rows * 12 * 4
    k2_bound_ms = k2_bytes / HBM_BYTES_PER_S * 1e3
    log(f"K2 at the headline cotangent: kernel {k2_ms:.4f} ms, plain "
        f"{k2_plain_ms:.4f} ms, index_add_ on unsorted rows "
        f"{k2_library_ms:.4f} ms, stable sort of the ids {k2_sort_ms:.4f} "
        f"ms, whole gather backward (sort + kernel) {k2_backward_ms:.4f} ms, "
        f"bound {k2_bound_ms:.4f} ms ({k2_bytes} bytes); profiled, device "
        f"busy: " + ", ".join(f"{k} {v[0]:.4f} ms in {v[1]} operations"
                              for k, v in busy.items()) + f" ({smi})")
    k2_busy_ms = busy["K2"][0]
    del (captured, ct_idx_sorted, ct_order, rows, block, idx, order, got,
         again, plain, presorted)
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
    # the step with the aligned walk and the permuting backward in turns
    # with this one, in this process
    step = make_train_step(opt, cfg)

    def paired_step(kind, i):
        old = kind == "aligned walk, permuting backward"
        traverse.bin_intersect = aligned_walk if old else k1.bin_intersect
        gather_mod.segment_sum_rows = (permuting_backward if old
                                       else segment_sum_rows)
        step(params, target)
    try:
        paired = in_turns(paired_step, (
            "own walk, fused backward", "aligned walk, permuting backward"),
            N_PAIRED // 2)
    finally:
        traverse.bin_intersect = k1.bin_intersect
        gather_mod.segment_sum_rows = segment_sum_rows
    log("all-leaves steps in turns: " + "; ".join(
        f"{k} median {float(np.median(v)):.3f} ms {[round(x, 3) for x in v]}"
        for k, v in paired.items()) + f" ({smi})")
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
        # esub 1 is the aligned walk: phase 3's t, and its ids but on rays
        # where the two walks tie by the oracle (as many as phase 2 found)
        same_t = torch.equal(hit1.t.reshape(RES_H, RES_W), outs[0].hit_t)
        tri_diff = int((hit1.tri.reshape(RES_H, RES_W)
                        != outs[0].hit_tri).sum())
        agree4 = float((hit4.tri == hit1.tri).float().mean())
        for e, (_, st) in stats.items():
            log(f"stats esub {e}: entries {st['entries']} overflow "
                f"{st['overflow']} cross {int(st['cross'])} steps mean "
                f"{float(st['steps'].float().mean())} sum "
                f"{int(st['steps'].sum())}; chunks mean "
                f"{float(st['chunks'].float().mean())} sum "
                f"{int(st['chunks'].sum())}")
        log(f"esub 1 with stats against phase 3's frame 0: t bitwise equal "
            f"{same_t}, ids differ on {tri_diff} rays (phase 2's ties: "
            f"{walk_ties}); esub 4 tri agreement with esub 1 {agree4}")
        if not same_t or tri_diff != walk_ties:
            raise RuntimeError("the telemetry frame's hits differ from K1's "
                               "beyond phase 2's ties")
        # frame 0's pose is the identity: the world frame is the object's
        check_ties("telemetry frame", hit1.tri.reshape(-1), "frame 0",
                   outs[0].hit_tri.reshape(-1), cam.ray_directions(),
                   cam.pos, obj.tris, cfg)
        frame_stats_ms = cuda_ms(lambda: binned(stats_cfgs[1]), PLAIN_REPS)
        frame_plain_ms = cuda_ms(lambda: binned(cfg), PLAIN_REPS)
        rays, b = bin_object(o_obj, obj.tris, proj, cfg, RES_H, RES_W)
        ops = (rays, b.geom, b.entry_tri, b.starts, chunk)
        # K3 against its plain version on the sphere, headline frame 0 and
        # a sphere whose every triangle is there twice (every hit an exact
        # tie between two ids), at esub 1, 2 and 4, with the steps output
        # and without it (K3's sliced instance; at esub 1 K1's walk): t,
        # tri and steps bitwise equal
        tie_tv = uv_sphere(100, 100)
        k3_cases = [("sphere 96x64", binned_case(uv_sphere(50, 50), 96, 64,
                                                 False)),
                    ("duplicated-triangle ties",
                     binned_case(np.concatenate([tie_tv, tie_tv]), RES_W,
                                 RES_H, True, pos=(0.2, 0.3, -2.5))),
                    ("headline frame 0", (rays, b))]
        k3_err = 0.0
        for name, (r_c, b_c) in k3_cases:
            ops_c = (r_c, b_c.geom, b_c.entry_tri, b_c.starts, chunk)
            for e, with_steps in itertools.product((1, 2, 4), (True, False)):
                got = k1.bin_intersect(*ops_c, esub=e, with_steps=with_steps)
                torch.cuda.synchronize()
                want = k1.bin_intersect_reference(*ops_c, esub=e,
                                                  with_steps=with_steps)
                torch.cuda.synchronize()
                eq = [torch.equal(x, y) for x, y in zip(got, want)]
                k3_err = max(k3_err, float((got[0] - want[0]).abs().max()))
                log(f"K3 vs plain [{name}, esub {e}, "
                    f"{'with' if with_steps else 'without'} steps]: t {eq[0]} "
                    f"tri {eq[1]}" + (f" steps {eq[2]}; slices scanned "
                                      f"{int(got[2][:, 0].sum())}"
                                      if with_steps else "")
                    + f"; hit_rate {float((got[1] >= 0).float().mean()):.6f}")
                if not all(eq):
                    raise RuntimeError(f"K3 and its plain version disagree on "
                                       f"{name} at esub {e}")
        steps = k1.bin_intersect(*ops, with_steps=True)[2]
        if not torch.equal(steps[:, 0], st1["steps"]):
            raise RuntimeError("kernel steps differ from the frame's")
        # the design and each lever switched off, in turns
        k3_levers = time_variants(
            "K3 (esub 1, with steps)",
            lambda **kw: k1._launch(*ops, cfg.eps, cfg.draw_distance, 1, True,
                                    **kw), WALK_LEVERS, smi)
        k3_ms = k3_levers["design"]
        k3_esub4_ms = cuda_ms(lambda: k1.bin_intersect(
            *ops, esub=4, with_steps=True), KERNEL_REPS)
        k3_plain_ms = cuda_ms(lambda: k1.bin_intersect_reference(
            *ops, with_steps=True), PLAIN_REPS)
        # the bound at K1's count: each entry of a slice whose gate opened
        # against every ray of its tile, and the select and division of the
        # pairs the test accepted
        n_tiles, p = rays.shape[:2]
        k3_entries, k3_accepted = k1.walk_work(*ops, esub=1, own=False)
        k3_pairs = int(k3_entries.sum()) * p
        k3_accepted = int(k3_accepted.sum())
        if k3_pairs != int(steps[:, 0].sum()) * chunk * p:
            raise RuntimeError("K3's pairs differ from its steps")
    k3_bound = op_bounds(k3_pairs * K1_OPS_PER_PAIR
                         + k3_accepted * K1_OPS_PER_ACCEPTED, k1_bytes,
                         clock_mhz)
    per_tile = steps[:, 0].float()
    log(f"K3 slices scanned a tile: max {int(per_tile.max())}, mean "
        f"{float(per_tile.mean()):.3f}; the {N_SMS} longest tiles hold "
        f"{float(per_tile.sort(descending=True).values[:N_SMS].sum() / per_tile.sum()):.3f}"
        f" of the pairs")
    log(f"K3 at esub 1 scanned {k3_pairs} ray-entry pairs "
        f"({int(steps[:, 0].sum())} blocks x {chunk} x {p}; K1 "
        f"{k1_pairs}), {k3_accepted} of them accepted; at K1's count "
        f"({K1_OPS_PER_PAIR} operations a pair, {K1_OPS_PER_ACCEPTED} more "
        f"an accepted one) {k3_bound['text']}; with steps {k3_ms:.4f} ms "
        f"({k3_bound['bound_issue_ms'] / k3_ms:.3f} of the issue bound), "
        f"esub 4 with steps {k3_esub4_ms:.4f} ms, plain with steps "
        f"{k3_plain_ms:.4f} ms; intersect_binned with stats "
        f"{frame_stats_ms:.4f} ms, without {frame_plain_ms:.4f} ms ({smi})")
    phase_done(8)

    # ---- 9. the cluster paths (K4, K5) ----
    accel, ccfgs, cluster_kernels = run_cluster_paths(
        dev, headline_tv, frames, idx_t, ref, smi, clock_mhz)
    phase_done(9)

    # ---- 10. the per-tile bin kernel K6 ----
    k6_kernel = run_bin_tile(dev, frames, idx_t, ref, cfg, smi, clock_mhz)
    phase_done(10)

    # ---- 11. the entry points: render_cli and animate ----
    cli_launches, animate_seen = run_entry_points(dev, headline_tv, smi)
    phase_done(11)

    # ---- 12. sharding at world size 1 over NCCL ----
    sharded = run_sharded(dev, headline_tv, frames, cfg, accel, ccfgs,
                          target, smi)
    phase_done(12)

    # ---- 13. the raster path on headline frame 0 ----
    run_raster(dev, frames, outs, idx_t, ref, smi)
    phase_done(13)

    # ---- 14. float64 ----
    run_f64(dev)
    phase_done(14)

    # ---- 15. render_jit and the compiled step ----
    compiled = run_jit(dev, headline_tv, frames, cfg, accel, ccfgs, target,
                       smi)
    phase_done(15)

    # ---- 16. the KD path: K7, its frame and its compiled step ----
    k7_kernel = run_kd(dev, headline_tv, frames, idx_t, ref, target, smi,
                       clock_mhz)
    k7_kernel["launches_by_path"]["render_cli"] = cli_launches["kd"]["K7"]
    compiled["segment_sum"]["train_jit_kd"] = k7_kernel.pop("k2_train_jit")
    phase_done(16)

    # ---- 17. the serving frame's kernels K8, K9, K10 and K11 ----
    train_k12_k13, serving = run_serving_kernels(dev, headline_tv, frames,
                                                 cfg, accel, ccfgs, target,
                                                 smi, clock_mhz)
    for entry in serving:
        paths = entry["launches_by_path"]
        for method, launched in cli_launches.items():
            paths[f"render_cli_{method}"] = launched[entry["name"]]
        paths["animate_replays"] = animate_seen[entry["name"]]
    phase_done(17)

    # ---- 18. the training shading's backward K12, the set-up's K13 ----
    serving += run_shade_grad(dev, headline_tv, cfg, target, smi, clock_mhz,
                              train_k12_k13)
    phase_done(18)

    kernels = [{
        "name": "bin_intersect", "route": "cuda",
        "source": "cpp_cuda_raytracer_dev_torch/csrc/bin_intersect.cu",
        "replaces": "cpp_cuda_raytracer_dev_tpu/ops/pallas/bin_kernel3.py:43",
        "launches": launches, "max_abs_err": max_abs_err,
        "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": k1_bound["bound_ms"], "bound_by": k1_bound["bound_by"],
        "library_ms": None, "bound_issue_ms": k1_bound["bound_issue_ms"],
        "pairs": k1_pairs, "accepted_pairs": k1_accepted,
        "index_order_ms": (turns[2] + turns[3]) / 2,
        "aligned_walk_ms": walk_ms,
        "launches_by_path": {"serve": launches, "train": train_k1,
                             "train_pose_light_camera": pose_k1}}, {
        "name": "bin_intersect_telemetry", "route": "cuda",
        "source": "cpp_cuda_raytracer_dev_torch/csrc/bin_intersect.cu",
        "replaces": "cpp_cuda_raytracer_dev_tpu/ops/pallas/bin_kernel2.py:62",
        "launches": k3_launches, "max_abs_err": k3_err,
        "ms": k3_ms, "plain_ms": k3_plain_ms,
        "bound_ms": k3_bound["bound_ms"], "bound_by": k3_bound["bound_by"],
        "library_ms": None, "bound_issue_ms": k3_bound["bound_issue_ms"],
        "pairs": k3_pairs, "accepted_pairs": k3_accepted,
        "ms_esub4": k3_esub4_ms, "levers_ms": k3_levers,
        "launches_by_path": {"stats_frames": k3_launches}}, {
        "name": "segment_sum", "route": "cuda",
        "source": "cpp_cuda_raytracer_dev_torch/csrc/segment_sum.cu",
        "replaces": "cpp_cuda_raytracer_dev_tpu/ops/gather.py:71",
        "launches": train_k2, "max_abs_err": k2_err,
        "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound_ms,
        "bound_by": "bytes", "library_ms": k2_library_ms,
        "bound_issue_ms": k2_bound_ms, "bytes": k2_bytes,
        "device_busy_ms": k2_busy_ms, "sort_ms": k2_sort_ms,
        "backward_ms": k2_backward_ms,
        "launches_by_path": {"serve": 0, "train": train_k2,
                             "train_pose_light_camera": pose_k2}},
        *cluster_kernels, k6_kernel, k7_kernel, *serving]
    for entry in kernels:     # phases 12 and 15, path by path
        entry["launches_by_path"].update(sharded.get(entry["name"], {}))
        entry["launches_by_path"].update(compiled.get(entry["name"], {}))
    log(f"profiled windows {len(LEAD_SEEN)}: lead-in kernels kept of "
        f"{LEAD_KERNELS}: least {min(LEAD_SEEN)}, median "
        f"{float(np.median(LEAD_SEEN))}, the last ten {LEAD_SEEN[-10:]}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def run_cluster_paths(dev, headline_tv, frames, idx_t, ref, smi, clock_mhz):
    """Phase 9 (see the module docstring): the cluster paths at the
    headline size. Returns the ClusterAccel, the two configurations and the
    kernels line's entries for K4 and K5."""
    from cpp_cuda_raytracer_dev_torch import (Camera, ClusterAccel, Pose,
                                              Scene, SceneObject, Triangles,
                                              render)
    from cpp_cuda_raytracer_dev_torch.accel import native
    from cpp_cuda_raytracer_dev_torch.accel import traverse as tr
    from cpp_cuda_raytracer_dev_torch.accel.kd_build import build_kd
    from cpp_cuda_raytracer_dev_torch.ops.cuda import segment_sum as k2
    from cpp_cuda_raytracer_dev_torch.ops.cuda import tile_intersect as k45
    from cpp_cuda_raytracer_dev_torch.ops.quaternion import from_axis_angle
    from cpp_cuda_raytracer_dev_torch.parallel.render_pjit import \
        make_train_step
    from cpp_cuda_raytracer_dev_torch.utils.procgen import uv_sphere

    cfgs = {k: c for k, c in headline_configs().items() if k != "bin"}
    c2 = cfgs["pallas2"]
    kernels = {"K4": (k45.tile_intersect_v2, k45.tile_intersect_v2_reference),
               "K5": (k45.tile_intersect, k45.tile_intersect_reference)}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    tris = frames[0][0].objects[0].tris
    if not native.native_available():
        raise RuntimeError(f"no native KD builder: {native.build_error()}")
    native_calls = []
    build_kd_native = native.build_kd_native
    native.build_kd_native = (lambda *a: native_calls.append(a[2:])
                              or build_kd_native(*a))
    try:
        t0 = time.perf_counter()
        accel = ClusterAccel.build(tris, leaf_size=c2.leaf_size, cache=False)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
    finally:
        native.build_kd_native = build_kd_native
    fill = (accel.slot_mat >= 0).sum(dim=1).float()
    log(f"ClusterAccel: {accel.num_clusters} clusters of at most "
        f"{int(fill.max())} triangles (mean {float(fill.mean()):.2f}), "
        f"{accel.geom9.shape[2]} slots, built in {build_s:.2f} s; native KD "
        f"builder calls {native_calls}")
    if not native_calls:
        raise RuntimeError("the ClusterAccel build did not run the native "
                           "KD builder")
    # the native builder against the numpy one on the same boxes
    p1, e1, e2 = (x.detach().cpu().numpy() for x in
                  (tris.p1, tris.e1, tris.e2))
    v = np.stack([p1, p1 + e1, p1 + e2], axis=1)
    amin, amax = v.min(axis=1), v.max(axis=1)
    t0 = time.perf_counter()
    tree_native = native.build_kd_native(amin, amax, c2.leaf_size)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tree_numpy = build_kd(amin, amax, c2.leaf_size)
    numpy_s = time.perf_counter() - t0
    same = all(np.array_equal(getattr(tree_native, f), getattr(tree_numpy, f))
               for f in ("bounds_min", "bounds_max", "cut_code", "s1", "s2",
                         "left", "right", "parent", "leaf_start",
                         "leaf_count", "perm"))
    log(f"KD build at {tris.p1x.shape[0]} triangles, leaf {c2.leaf_size}: "
        f"native {native_s:.3f} s, numpy {numpy_s:.3f} s; "
        f"{tree_native.num_nodes} nodes, trees bitwise equal {same}")
    if not same:
        raise RuntimeError("the native KD tree differs from numpy's")
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

    # kernels against their plain versions on identical operands; the tie
    # scene holds every triangle twice (ids i and i + n, neighbouring
    # slots of one cluster, so in different slot groups), which makes every
    # hit an exact tie for the within-cluster rule
    sphere_tris = Triangles.from_vertices(uv_sphere(50, 50), device=dev)
    tv_dup = uv_sphere(100, 100)
    dup_tris = Triangles.from_vertices(np.concatenate([tv_dup, tv_dup]),
                                       device=dev)
    cases = [
        ("sphere 96x64", Scene([SceneObject(sphere_tris)]),
         camera((0.0, 0.0, -3.0), 96, 64),
         ClusterAccel.build(sphere_tris, leaf_size=128, cache=False), c2, 96,
         64),
        ("dragon-class frame 0", *frames[0], accel, c2, RES_W, RES_H),
        ("dragon-class grazing, 4 candidates", Scene([SceneObject(tris)]),
         camera((1.8, 0.3, 1.6), RES_W, RES_H), accel,
         dataclasses.replace(c2, max_candidates=4), RES_W, RES_H),
        ("duplicated-triangle ties", Scene([SceneObject(dup_tris)]),
         camera((0.2, 0.3, -2.5), RES_W, RES_H),
         ClusterAccel.build(dup_tris, leaf_size=128, cache=False),
         dataclasses.replace(c2, max_candidates=16), RES_W, RES_H)]
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
                frame0, escal0 = first, second
            p_case = first[0].shape[2]
            for kname, (fn, plain) in kernels.items():
                for pname, ops in (("first pass", first),
                                   ("escalation pass", second)):
                    for subs in ({}, {"n_sub": p_case, "count_subs": True}):
                        got = fn(*ops, **subs)
                        torch.cuda.synchronize()
                        want = plain(*ops, **subs)
                        torch.cuda.synchronize()
                        eq = [torch.equal(x, y) for x, y in zip(got, want)]
                        err = float((got[0] - want[0]).abs().max())
                        max_err[kname] = max(max_err[kname], err)
                        log(f"{kname} vs plain [{name}, {pname}"
                            f"{', count_subs' if subs else ''}]: "
                            f"t_bitwise_equal {eq[0]} tri_equal {eq[1]} "
                            f"steps_equal {eq[2]} max_abs_err {err} hit_rate "
                            f"{float((got[1] >= 0).float().mean()):.6f} "
                            f"candidates visited {int(got[2][:, 0].sum())}"
                            + (f", rays past a box test "
                               f"{int(got[2][:, 1].sum())}" if subs else ""))
                        if not all(eq):
                            raise RuntimeError(
                                f"{kname} and its plain version disagree on "
                                f"{name}, {pname}, {subs}")
            if name == "duplicated-triangle ties":
                for kname, (fn, _) in kernels.items():
                    tie_rule_holds(kname, fn(*first)[1], acc.slot_mat)

        # lane efficiency of one ray a thread on frame 0: the rays past a
        # box test (one sub-tile a ray) against 32 x the warps (32-ray
        # sub-tiles) holding one
        p = frame0[0].shape[2]
        lane_eff = {}
        for kname, (fn, _) in kernels.items():
            rays = int(fn(*frame0, n_sub=p, count_subs=True)[2][:, 1].sum())
            warps = int(fn(*frame0, n_sub=p // 32,
                           count_subs=True)[2][:, 1].sum())
            lane_eff[kname] = rays / max(1, 32 * warps)
            log(f"{kname} frame 0 lane efficiency of one ray a thread: "
                f"{rays} rays past a box test in {warps} warps that run the "
                f"slot loop: {lane_eff[kname]:.4f}")

        ms = {}
        for kname, (fn, plain) in kernels.items():
            ms[kname] = (cuda_ms(lambda: fn(*frame0), KERNEL_REPS),
                         cuda_ms(lambda: plain(*frame0), PLAIN_REPS))
            log(f"{kname} at headline frame 0 ({frame0[0].shape[0]} tiles x "
                f"{frame0[0].shape[2]} rays, K {frame0[1].shape[1]}): kernel "
                f"{ms[kname][0]:.4f} ms, plain {ms[kname][1]:.4f} ms ({smi})")
        ms_esc = (cuda_ms(lambda: k45.tile_intersect_v2(*escal0),
                          KERNEL_REPS),
                  cuda_ms(lambda: k45.tile_intersect_v2_reference(*escal0),
                          PLAIN_REPS))
        log(f"K4 escalation pass of headline frame 0 ({escal0[0].shape[0]} "
            f"tiles, K {escal0[1].shape[1]}): kernel {ms_esc[0]:.4f} ms, "
            f"plain {ms_esc[1]:.4f} ms ({smi})")
        lever_ms = time_levers(k45, frame0, smi)
        k14 = run_k14(frames[0], accel, c2, smi, clock_mhz)

    # serve frames through the entry point, one path at a time
    served, launches = {}, {}
    for method, n in N_CLUSTER_FRAMES.items():
        k45.tile_intersect_v2.launches = 0
        k45.tile_intersect.launches = 0
        k45.cluster_cull.launches = 0
        frame_ms, outs = [], []
        for scene, cam in frames[:n]:
            start.record()
            out = render(scene, cam, cfgs[method], accel=(accel,))
            end.record()
            torch.cuda.synchronize()
            frame_ms.append(start.elapsed_time(end))
            outs.append(out)
        launches[method] = (k45.tile_intersect_v2.launches,
                            k45.tile_intersect.launches,
                            k45.cluster_cull.launches)
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
    # K14: a pallas2 frame's first pass and its escalation, a pallas
    # frame's one pass
    if launches["pallas2"][2] != 2 * N_CLUSTER_FRAMES["pallas2"] or \
            launches["pallas"][2] != N_CLUSTER_FRAMES["pallas"]:
        raise RuntimeError(f"the cluster frames launched K14 "
                           f"{[launches[m][2] for m in launches]} times")

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
        # the work each launch needs, its pairs (see pair_count)
        entries = {}
        for kname, ops_pair, ops, pname, kms in (
                ("K4", K4_OPS_PER_PAIR, frame0, "first pass", ms["K4"][0]),
                ("K5", K5_OPS_PER_PAIR, frame0, "first pass", ms["K5"][0]),
                ("K4", K4_OPS_PER_PAIR, escal0, "escalation pass",
                 ms_esc[0])):
            fn = kernels[kname][0]
            pairs, nbytes, past, read_n, read_tris = pair_count(fn, ops,
                                                                accel)
            rays = int(past.sum())
            if pname == "first pass" and not torch.equal(past,
                                                         tele[kname][:, 1]):
                raise RuntimeError(f"{kname}'s cut walks disagree with its "
                                   "telemetry")
            bound = op_bounds(pairs * ops_pair, nbytes, clock_mhz)
            bound["pairs"] = pairs
            entries[kname if pname == "first pass" else "K4 escalation"] = \
                bound
            log(f"{kname} {pname} on frame 0: {pairs} (ray, triangle) pairs "
                f"past the box test ({rays} rays x "
                f"{pairs / max(1, rays):.2f} triangles; {rays * n_slots} with "
                f"the {n_slots} slots), {read_n} clusters of {read_tris} "
                f"triangles read, {ops_pair} FP32 operations a pair; "
                f"{bound['text']}; kernel {kms:.4f} ms, "
                f"{bound['bound_issue_ms'] / kms:.3f} of the issue bound "
                f"({smi})")

    return accel, cfgs, [{
        "name": "tile_intersect_v2", "route": "cuda",
        "source": "cpp_cuda_raytracer_dev_torch/csrc/tile_intersect.cu",
        "replaces": "cpp_cuda_raytracer_dev_tpu/ops/pallas/"
                    "intersect_kernel_v2.py:58",
        "launches": launches["pallas2"][0], "max_abs_err": max_err["K4"],
        "ms": ms["K4"][0], "plain_ms": ms["K4"][1],
        "bound_ms": entries["K4"]["bound_ms"],
        "bound_by": entries["K4"]["bound_by"], "library_ms": None,
        "bound_issue_ms": entries["K4"]["bound_issue_ms"],
        "pairs": entries["K4"]["pairs"], "lane_efficiency": lane_eff["K4"],
        "escalation_ms": ms_esc[0], "escalation_plain_ms": ms_esc[1],
        "escalation_bound_ms": entries["K4 escalation"]["bound_ms"],
        "escalation_bound_issue_ms":
            entries["K4 escalation"]["bound_issue_ms"],
        "escalation_pairs": entries["K4 escalation"]["pairs"],
        "levers_ms": lever_ms["K4"],
        "launches_by_path": {"serve_pallas2": launches["pallas2"][0],
                             "serve_pallas": launches["pallas"][0],
                             "train_pallas2": train_k4}}, {
        "name": "tile_intersect", "route": "cuda",
        "source": "cpp_cuda_raytracer_dev_torch/csrc/tile_intersect.cu",
        "replaces": "cpp_cuda_raytracer_dev_tpu/ops/pallas/"
                    "intersect_kernel.py:55",
        "launches": launches["pallas"][1], "max_abs_err": max_err["K5"],
        "ms": ms["K5"][0], "plain_ms": ms["K5"][1],
        "bound_ms": entries["K5"]["bound_ms"],
        "bound_by": entries["K5"]["bound_by"], "library_ms": None,
        "bound_issue_ms": entries["K5"]["bound_issue_ms"],
        "pairs": entries["K5"]["pairs"], "lane_efficiency": lane_eff["K5"],
        "levers_ms": lever_ms["K5"],
        "launches_by_path": {"serve_pallas2": launches["pallas2"][1],
                             "serve_pallas": launches["pallas"][1],
                             "train_pallas2": 0}}, dict(
        k14, launches=launches["pallas2"][2],
        launches_by_path={"serve_pallas2": launches["pallas2"][2],
                          "serve_pallas": launches["pallas"][2]})]


def run_k14(frame, accel, c2, smi, clock_mhz) -> dict:
    """K14 (the cull) against its plain twin on one headline frame: the
    two-level first pass over every tile, and a flat pass at the
    ``pallas2.orbit`` bucket (`K14_BUCKET`: the tiles with the most
    overflow, padded with the next ones, at 128 candidates), outputs
    bitwise; each pass and its twin timed. Returns the kernels line's
    entry for K14."""
    from cpp_cuda_raytracer_dev_torch.accel import traverse as tr
    scene, cam = frame
    obj = scene.objects[0]
    o = obj.pose.inv_apply(cam.pos)
    d = obj.pose.inv_apply_vec(cam.ray_directions())
    th, tw = c2.tile_h, c2.tile_w
    k = min(c2.max_candidates, accel.num_clusters)
    tiles, _ = tr._tile_rays(d, RES_H, RES_W, th, tw)
    c, group = accel.num_clusters, c2.group_size
    ng = -(-c // group)
    kg = min(c2.max_groups, ng)
    _, _, ovf = tr.cull_tiles_hier(o, tiles, accel, th, tw, k, group, kg)
    et = tiles[torch.sort(ovf, descending=True,
                          stable=True).indices[:K14_BUCKET[0]]]
    k2 = min(K14_BUCKET[1], c)

    def twin(out):
        return (*out, tr._candidate_boxes(o, accel, out[0], out[1]))
    passes = {
        "first pass": (
            lambda: tr.cull_tiles_hier(o, tiles, accel, th, tw, k, group, kg,
                                       boxes=True),
            lambda: twin(tr.cull_tiles_hier_reference(
                o, tiles, accel, th, tw, k, group, kg)),
            tiles.shape[0] * (ng + kg * group), k, tiles.shape[0]),
        "escalation pass": (
            lambda: tr.cull_tiles(o, et, accel, th, tw, k2, boxes=True),
            lambda: twin(tr.cull_tiles_reference(o, et, accel, th, tw, k2)),
            et.shape[0] * c, k2, et.shape[0])}
    entry = {"name": "cluster_cull", "route": "cuda",
             "source": "cpp_cuda_raytracer_dev_torch/csrc/tile_intersect.cu",
             "replaces": "cpp_cuda_raytracer_dev_tpu/accel/traverse.py:300,"
                         "319,415 (plain jnp, no Pallas kernel)",
             "max_abs_err": 0.0, "library_ms": None}
    for pname, (fn, plain, tests, kk, n_t) in passes.items():
        got, want = fn(), plain()
        torch.cuda.synchronize()
        eq = [torch.equal(x, y) for x, y in zip(got, want)]
        log(f"K14 vs plain [headline frame 0, {pname}, {n_t} tiles at K "
            f"{kk}]: cand, count, overflow, boxes bitwise {eq}; count mean "
            f"{float(want[1].float().mean()):.2f}, overflow tiles "
            f"{int((want[2] > 0).sum())}")
        if not all(eq):
            raise RuntimeError(f"K14 and its plain twin disagree ({pname})")
        kms, pms = cuda_ms(fn, KERNEL_REPS), cuda_ms(plain, PLAIN_REPS)
        # the cluster bounds read once, the tiles' five rays, the lists,
        # counts and boxes written
        nbytes = (c * 24 + n_t * (5 * 12 + 8 + kk * (4 + 32))
                  + (ng * 24 if pname == "first pass" else 0))
        bound = op_bounds(tests * K14_OPS_PER_TEST, nbytes, clock_mhz)
        log(f"K14 {pname}: {tests} box tests at {K14_OPS_PER_TEST} FP32 "
            f"operations; {bound['text']}; kernel {kms:.4f} ms, plain "
            f"{pms:.4f} ms ({smi})")
        key = "" if pname == "first pass" else "escalation_"
        entry.update({f"{key}ms": kms, f"{key}plain_ms": pms,
                      f"{key}bound_ms": bound["bound_ms"],
                      f"{key}bound_by": bound["bound_by"],
                      f"{key}bound_issue_ms": bound["bound_issue_ms"],
                      f"{key}box_tests": tests})
    return entry


def tie_rule_holds(kname, tri, slot_mat):
    """On the duplicated-triangle scene (ids i and i + n the same triangle),
    where a hit triangle's copy lies in the same cluster, K4 must have taken
    the lower slot and K5 the lower id; that is so for most hits."""
    n2 = int(slot_mat.max()) + 1
    c, s = (slot_mat >= 0).nonzero(as_tuple=True)
    ids = slot_mat[c, s].long()
    cluster = torch.full((n2,), -1, device=tri.device, dtype=torch.long)
    slot = torch.full((n2,), -1, device=tri.device, dtype=torch.long)
    cluster[ids], slot[ids] = c, s
    hit = tri[tri >= 0].long()
    dup = (hit + n2 // 2) % n2
    same = cluster[hit] == cluster[dup]
    won = slot[hit] < slot[dup] if kname == "K4" else hit < dup
    log(f"{kname} tie scene: {int(same.sum())} of {hit.numel()} hits tie "
        f"with a copy in the same cluster, the rule's winner on "
        f"{int(won[same].sum())}")
    if float(same.float().mean()) <= 0.5 or not bool(won[same].all()):
        raise RuntimeError(f"{kname} broke the within-cluster tie rule")


def pair_count(fn, ops, accel):
    """The work one tile-intersect launch needs: each ray past a candidate's
    box test against that cluster's triangles, not its padding slots. A walk
    cut to its first k candidates takes the same steps up to k, so the ray
    counts at count = min(count, k) for k = 0..K differ by the rays past each
    candidate's box test. Returns (pairs, bytes, each tile's rays past a box
    test, clusters read, their triangles)."""
    n_t, _, p = ops[0].shape
    past = torch.stack([fn(*ops[:2], ops[2].clamp_max(k), *ops[3:], n_sub=p,
                           count_subs=True)[2][:, 1]
                        for k in range(ops[1].shape[1] + 1)], dim=1)
    rays_k = past.diff(dim=1).long()                             # (nT, K)
    tri_fill = (accel.slot_mat >= 0).sum(dim=1)[ops[1].long().clamp_min(0)]
    pairs = int((rays_k * tri_fill).sum())
    read = ops[1][rays_k > 0].long().unique()
    read_tris = int((accel.slot_mat[read] >= 0).sum())
    nbytes = (sum(x.numel() for x in ops[:5]) * 4 + read_tris * 10 * 4
              + n_t * (p * 8 + 8))
    return pairs, nbytes, past[:, -1], read.numel(), read_tris


def time_levers(k45, ops, smi):
    """K4 and K5 on ``ops`` with each design lever switched off in turn
    (every slot instead of the fill cut, no compaction of the rays past a
    box test, no prefetch, the tiles in index order) and at one or four
    rays a thread in the slot loop (in place of 1-4 from the rays that
    passed), each timed in turns with the full design (`time_variants`).
    Returns {kernel: {variant: ms}}."""
    variants = {"design": {}, "all_slots": {"levers": 1},
                "no_compaction": {"levers": 2}, "no_prefetch": {"prefetch": 0},
                "index_order": {"longest_first": False},
                "one_ray_a_thread": {"levers": 4},
                "four_rays_a_thread": {"levers": 8}}
    return {kname: time_variants(
        kname, lambda gen=gen, **kw: k45._launch(
            gen, *ops, k45.MT_EPSILON, k45.DEFAULT_DRAW_DISTANCE, 1, False,
            **kw), variants, smi)
        for gen, kname in ((4, "K4"), (5, "K5"))}


def time_variants(kname, run, variants, smi):
    """``run(**kw)`` (one launch of a kernel on the headline operands) for
    each {name: kw} of ``variants``, timed in turns (the list, then in
    reverse) with CUDA events. Each variant must give the first one's (the
    design's) result bit for bit. Returns {variant: ms}."""
    want = run()
    for name, kw in variants.items():
        if not all(torch.equal(x, y) for x, y in zip(run(**kw), want)):
            raise RuntimeError(f"{kname} variant {name} changed a result")
    ms = {name: [] for name in variants}
    for order in (list(variants), list(variants)[::-1]):
        for name in order:
            ms[name].append(cuda_ms(lambda: run(**variants[name]),
                                    KERNEL_REPS))
    out = {name: sum(v) / len(v) for name, v in ms.items()}
    log(f"{kname} levers on headline frame 0, ms (mean of two turns): "
        + ", ".join(f"{n} {v:.4f}" for n, v in out.items()) + f" ({smi})")
    return out


def run_bin_tile(dev, frames, idx_t, ref, cfg, smi, clock_mhz):
    """Phase 10 (see the module docstring): kernel K6 on the port's own
    binning. Returns the kernels line's entry for K6."""
    from cpp_cuda_raytracer_dev_torch import (Camera, Scene, SceneObject,
                                              Triangles)
    from cpp_cuda_raytracer_dev_torch.accel import traverse as tr
    from cpp_cuda_raytracer_dev_torch.ops.cuda import bin_intersect as k1
    from cpp_cuda_raytracer_dev_torch.ops.cuda import bin_tile_intersect as bt
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
        def camera(pos, w, h):
            return Camera.create(w, h, pos=list(pos), look_at=[0.0, 0.0, 0.0],
                                 up=[0.0, 1.0, 0.0], film_h=0.024,
                                 focal=0.055, device=dev)
        # the sphere, a sphere whose every triangle is there twice (every
        # hit an exact tie between two slots), and frame 0, last
        sphere = Triangles.from_vertices(uv_sphere(50, 50), device=dev)
        tie_tv = uv_sphere(100, 100)
        ties = Triangles.from_vertices(np.concatenate([tie_tv, tie_tv]),
                                       device=dev)
        cases = [("sphere 96x64", Scene([SceneObject(sphere)]),
                  camera((0.0, 0.0, -3.0), 96, 64),
                  dataclasses.replace(cfg, backface_cull=False), 96, 64),
                 ("duplicated-triangle ties", Scene([SceneObject(ties)]),
                  camera((0.2, 0.3, -2.5), RES_W, RES_H), cfg, RES_W, RES_H),
                 ("dragon-class frame 0", *frames[0], cfg, RES_W, RES_H)]
        max_err = 0.0
        for name, scene, cam, c, w, h in cases:
            o, rays, b, ops = operands(scene, cam, c, w, h)
            base = None
            for n_sub, mode in itertools.product((1, 2, 16), (0, 1, 2)):
                got = bt.bin_tile_intersect(*ops, chunk=chunk, n_sub=n_sub,
                                            debug_mode=mode)
                torch.cuda.synchronize()
                want = bt.bin_tile_intersect_reference(
                    *ops, chunk=chunk, n_sub=n_sub, debug_mode=mode)
                torch.cuda.synchronize()
                eq = [torch.equal(x, y) for x, y in zip(got, want)]
                ids_eq = torch.equal(decode(got[1], b), decode(want[1], b))
                err = float((got[0] - want[0]).abs().max())
                max_err = max(max_err, err)
                same_hits = base is None or (torch.equal(got[0], base[0])
                                             and torch.equal(got[1], base[1]))
                log(f"K6 vs plain [{name}, n_sub {n_sub}, debug_mode "
                    f"{mode}]: t_bitwise_equal {eq[0]} enc_equal {eq[1]} "
                    f"steps_equal {eq[2]} ids_equal {ids_eq} max_abs_err "
                    f"{err} same hits as n_sub 1 mode 0 {same_hits}; chunks "
                    f"walked {int(got[2][:, 0].sum())} of "
                    f"{int(got[2][:, 1].sum())}, hit_rate "
                    f"{float((got[1] >= 0).float().mean()):.6f}")
                if not (all(eq) and ids_eq and same_hits):
                    raise RuntimeError(f"K6 and its plain version disagree on "
                                       f"{name}, n_sub {n_sub}, debug_mode "
                                       f"{mode}")
                if base is None:
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
        log(f"K6 vs K1 on frame 0: t bitwise equal {torch.equal(t6, t1)}, "
            f"ids differ on {int((tri6 != tri1).sum())} of {tri6.numel()} "
            f"rays")
        check_ties("K6", tri6, "K1", tri1, rays, o,
                   frames[0][0].objects[0].tris, cfg)

        # frame 0 against phase 4's oracle rays
        img_tri = tr._untile(tri6, tr._bin_meta(cfg, RES_H, RES_W), RES_H,
                             RES_W).reshape(-1)
        agree = float((img_tri[idx_t] == ref.tri).float().mean())
        log(f"K6 frame 0 oracle agreement {agree:.6f} on {N_SAMPLE} rays")
        if agree < MIN_AGREE:
            raise RuntimeError(f"K6 oracle agreement {agree} < {MIN_AGREE}")

        # the design and each lever switched off, in turns
        levers = time_variants(
            "K6", lambda **kw: bt._launch(*ops, chunk, cfg.eps,
                                          cfg.draw_distance, 1, 0, **kw),
            WALK_LEVERS, smi)
        kernel_ms = levers["design"]
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
    bound = op_bounds(pairs * K6_OPS_PER_PAIR + entries * K6_OPS_PER_ENTRY,
                      nbytes, clock_mhz)
    per_tile = gated.float()
    log(f"K6 chunks a tile: walked max {int(walked.max())}, gate open max "
        f"{int(per_tile.max())}, mean {float(per_tile.mean()):.3f}; the "
        f"{N_SMS} longest tiles hold "
        f"{float(per_tile.sort(descending=True).values[:N_SMS].sum() / per_tile.sum()):.3f}"
        f" of the pairs")
    log(f"K6 at headline frame 0 ({n_t} tiles x {p} rays, chunk {chunk}): "
        f"chunks in range {int(steps6[:, 1].sum())}, walked "
        f"{int(walked.sum())}, gate open {int(gated.sum())}; {pairs} "
        f"ray-entry pairs, {K6_OPS_PER_PAIR} FP32 operations a pair and "
        f"{K6_OPS_PER_ENTRY} an entry constant; {bound['text']}; kernel "
        f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms ({smi})")
    return {
        "name": "bin_tile_intersect", "route": "cuda",
        "source": "cpp_cuda_raytracer_dev_torch/csrc/bin_tile_intersect.cu",
        "replaces": "cpp_cuda_raytracer_dev_tpu/ops/pallas/bin_kernel.py:42",
        "launches": launches, "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
        "library_ms": None, "bound_issue_ms": bound["bound_issue_ms"],
        "pairs": pairs, "levers_ms": levers,
        "launches_by_path": {"bin_tile_frames": launches}}


def nccl_capture_check(dev, mesh) -> None:
    """An NCCL all-reduce and all-gather over the mesh's "rays" group,
    captured by the capture cache's own `capture` (a warm-up on a side
    stream, then the capture, with torch.cuda.graph's default
    ``capture_error_mode``) between two elementwise kernels, replayed on two
    new inputs: the outputs must be the collectives' bitwise. At world size
    1 the compiled sharded frame and step skip their collectives, so this is
    the check that a collective captures and replays on this card."""
    import torch.distributed as dist

    from cpp_cuda_raytracer_dev_torch.utils import graphs

    group = mesh.get_group("rays")
    n = dist.get_world_size(group)
    x = torch.zeros(4096, device=dev)

    def body(args, _bucket):
        y = args * 2.0 + 1.0
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        parts = [torch.empty_like(y) for _ in range(n)]
        dist.all_gather(parts, y, group=group)
        return torch.cat(parts) - 1.0, None
    graph, (out, _) = graphs.capture(lambda: body(x, None),
                                     torch.cuda.graph_pool_handle())
    ok = []
    for v in (3.0, -5.5):
        x.fill_(v)
        graph.replay()
        torch.cuda.synchronize()
        ok.append(torch.equal(out, torch.full((n * 4096,),
                                                   (2 * v + 1) * n - 1,
                                                   device=dev)))
    log(f"NCCL all_reduce and all_gather over {n} rank(s), captured in a "
        f"CUDA graph and replayed on two new inputs: bitwise the "
        f"collectives' results {ok}")
    if not all(ok):
        raise RuntimeError("a captured NCCL collective replayed wrongly")


def run_sharded(dev, headline_tv, frames, cfg, accel, ccfgs, target, smi):
    """Phase 12 (see the module docstring): the sharded entry points at
    world size 1 over NCCL, in this process, eager and compiled. Returns
    {kernel name: {path: launches}} for the kernels line (the compiled
    paths: the instances the profiler saw in one replay)."""
    import socket

    import torch.distributed as dist

    from cpp_cuda_raytracer_dev_torch import (Camera, Pose, RenderConfig,
                                              Scene, SceneObject, Triangles,
                                              render)
    from cpp_cuda_raytracer_dev_torch.ops.cuda import bin_intersect as k1
    from cpp_cuda_raytracer_dev_torch.ops.cuda import bin_prepass as bp
    from cpp_cuda_raytracer_dev_torch.ops.cuda import segment_sum as k2
    from cpp_cuda_raytracer_dev_torch.ops.cuda import shade as k10
    from cpp_cuda_raytracer_dev_torch.ops.cuda import tile_intersect as k45
    from cpp_cuda_raytracer_dev_torch.ops.quaternion import from_axis_angle
    from cpp_cuda_raytracer_dev_torch.parallel import mesh as pm
    from cpp_cuda_raytracer_dev_torch.parallel import render_pjit as pj
    from cpp_cuda_raytracer_dev_torch.utils.procgen import dragon_class_mesh

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    pm.initialize_distributed(f"localhost:{port}", 1, 0, device_type="cuda")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    out = {}
    try:
        if dist.get_backend() != "nccl":
            raise RuntimeError(f"backend {dist.get_backend()}, not NCCL")
        mesh1 = pm.make_mesh(1)
        mesh11 = pm.make_mesh(1, prims_axis=True)
        log(f"process group: {dist.get_backend()}, world size "
            f"{dist.get_world_size()}; meshes {mesh1.mesh_dim_names} "
            f"{tuple(mesh1.shape)} and {mesh11.mesh_dim_names} "
            f"{tuple(mesh11.shape)}")
        scene, cam = frames[0]
        c2, c5 = ccfgs["pallas2"], ccfgs["pallas"]
        acc = (accel,)
        # K8 and K9 on every bin path, K10 and K11 on every serving path
        prep = [bp.bin_tri_pass, bp.ray_table, bp.bin_entry_keys,
                bp.bin_entry_table, k10.shade_compose, k10.frame_setup]
        shade = [k10.shade_compose, k10.frame_setup]
        cases = [
            ("render_sharded bin", "sharded_bin",
             lambda: pj.render_sharded(scene, cam, cfg, mesh1),
             lambda: render(scene, cam, cfg), [k1.bin_intersect, *prep]),
            ("render_sharded pallas2", "sharded_pallas2",
             lambda: pj.render_sharded(scene, cam, c2, mesh1, acc),
             lambda: render(scene, cam, c2, acc),
             [k45.tile_intersect_v2, *shade]),
            ("render_sharded pallas", "sharded_pallas",
             lambda: pj.render_sharded(scene, cam, c5, mesh1, acc),
             lambda: render(scene, cam, c5, acc),
             [k45.tile_intersect, *shade]),
            ("render_sharded_2d_bin", "sharded_2d_bin",
             lambda: pj.render_sharded_2d_bin(scene, cam, cfg, mesh11),
             lambda: render(scene, cam, cfg), [k1.bin_intersect, *prep]),
            ("render_sharded_2d_accel pallas2", "sharded_2d_accel",
             lambda: pj.render_sharded_2d_accel(scene, cam, c2, mesh11, acc),
             lambda: render(scene, cam, c2, acc),
             [k45.tile_intersect_v2, *shade])]
        # the brute 2-D path at a cut size: ~4e11 pairs at the headline
        cut_tris = Triangles.from_vertices(
            dragon_class_mesh(SHARDED_2D_TRIS), device=dev)
        cut_scene = Scene([SceneObject(cut_tris)])
        fixed = RenderConfig(method="fixed", chunk=2048)
        cases.append((f"render_sharded_2d fixed ({cut_tris.p1x.shape[0]} "
                      "triangles, cut)", "sharded_2d",
                      lambda: pj.render_sharded_2d(cut_scene, cam, fixed,
                                                   mesh11),
                      lambda: render(cut_scene, cam, fixed), shade))
        for name, path, fn, ref_fn, kernels in cases:
            with torch.inference_mode():
                want = ref_fn()
                fn()       # warm-up: a mesh's first collective sets up NCCL
                torch.cuda.synchronize()
                for k in kernels:
                    k.launches = 0
                start.record()
                got = fn()
                end.record()
                torch.cuda.synchronize()
            counts = [k.launches for k in kernels]
            for k, n in zip(kernels, counts):
                out.setdefault(k.__name__, {})[path] = n
            equal = {f: torch.equal(getattr(got, f), getattr(want, f))
                     for f in ("hit_t", "hit_tri", "hit_obj", "image",
                               "radiance", "normal", "point")}
            log(f"{name}: {start.elapsed_time(end):.3f} ms, launches "
                f"{counts}, hit rate "
                f"{float((got.hit_tri >= 0).float().mean()):.6f}; bitwise "
                f"render's frame: {equal} ({smi})")
            if not all(equal.values()):
                raise RuntimeError(f"{name} differs from render's frame")
            if not all(counts):
                raise RuntimeError(f"{name} did not launch its kernels")

        # one sharded all-leaves step against the single-device step from
        # the same parameters
        def params():
            tris = Triangles.from_vertices(frames[0][0].objects[0].tris
                                           .vertices().detach(), device=dev)
            pose = Pose(from_axis_angle([0.0, 1.0, 0.0], math.radians(1.0),
                                        device=dev),
                        torch.zeros(3, device=dev))
            tcam = Camera.create(RES_W, RES_H, pos=[0.0, 0.0, -3.0],
                                 look_at=[0.0, 0.0, 0.0], up=[0.0, 1.0, 0.0],
                                 film_h=0.024, focal=0.055,
                                 device=dev).requires_grad_()
            p = {"scene": Scene([SceneObject(tris, pose)]), "camera": tcam}
            return p, [*p["scene"].parameters(), *tcam.parameters()]
        single, single_list = params()
        loss1 = pj.make_train_step(torch.optim.SGD(single_list, lr=LR),
                                   cfg)(single, target)
        shard, shard_list = params()
        for k in (k1.bin_intersect, k2.segment_sum, *prep, k10.shade_grad,
                  k10.frame_setup_grad):
            k.launches = 0
        start.record()
        loss2 = pj.make_train_step(torch.optim.SGD(shard_list, lr=LR), cfg,
                                   mesh1)(shard, target)
        end.record()
        torch.cuda.synchronize()
        counts = (k1.bin_intersect.launches, k2.segment_sum.launches)
        out.setdefault("bin_intersect", {})["sharded_train"] = counts[0]
        out.setdefault("segment_sum", {})["sharded_train"] = counts[1]
        for k in (*prep, k10.shade_grad, k10.frame_setup_grad):
            out.setdefault(k.__name__, {})["sharded_train"] = k.launches
        if not bp.bin_tri_pass.launches or k10.shade_compose.launches != 1 \
                or k10.shade_grad.launches != 1 \
                or k10.frame_setup.launches != 1 \
                or k10.frame_setup_grad.launches != 1:
            raise RuntimeError("the sharded step skipped K8, or did not "
                               "shade through K10 and K12 once or set up "
                               "through K11 and K13 once")
        finite = all(bool(torch.isfinite(p.grad).all()) for p in shard_list)
        same_p = all(torch.equal(a, b) for a, b in zip(shard_list,
                                                       single_list))
        same_g = all(torch.equal(a.grad, b.grad)
                     for a, b in zip(shard_list, single_list))
        log(f"sharded all-leaves step: {start.elapsed_time(end):.3f} ms, "
            f"loss {float(loss2)} (single device {float(loss1)}), launches "
            f"bin_intersect {counts[0]} segment_sum {counts[1]}; "
            f"{len(shard_list)} gradients finite {finite}, gradients "
            f"bitwise the single-device step's {same_g}, parameters "
            f"{same_p} ({smi})")
        if not (finite and same_p and same_g and all(counts)):
            raise RuntimeError("the sharded step differs from the "
                               "single-device step or missed a kernel")

        # the compiled sharded paths against the eager ones
        nccl_capture_check(dev, mesh1)
        kd_tab = kd_tables(dev, headline_tv)
        for method, c, a, kname in (
                ("bin", cfg, None, "bin_intersect"),
                ("pallas2", c2, acc, "tile_intersect_v2"),
                ("pallas", c5, acc, "tile_intersect"),
                ("kd", RenderConfig(method="kd"), (kd_tab,), "kd_traverse")):
            seen = jit_frames(method, c, a, kname, frames, smi, mesh=mesh1)
            out.setdefault(kname, {})["sharded_jit"] = seen[kname]
            for k in SERVING_KERNELS:
                out.setdefault(k, {})[f"sharded_jit_{method}"] = seen[k]
        seen = jit_steps(dev, headline_tv, cfg, None, "bin_intersect",
                         target, smi, mesh=mesh1, turns=N_PAIRED)
        for kname, n in seen.items():
            out.setdefault(kname, {})["sharded_train_jit"] = n
    finally:
        pj.SHARDED_GRAPHS.clear()
        dist.destroy_process_group()
    return out


def check_raster_against_k1(tri_r, tri_k, rays, o, tris, cfg) -> int:
    """Every ray on which the raster frame's id and K1's differ must be an
    oracle tie (both triangles' t within 1e-5 of the oracle's) or a ray
    where the raster id is the mt_fixed_origin oracle's: K1's folded
    epsilons accept a few edge pairs that the oracle rejects (ROADMAP F2).
    Prints each ray; returns how many of them K1 got wrong."""
    from cpp_cuda_raytracer_dev_torch.ops.intersect import (FixedOriginCache,
                                                            mt_fixed_origin)
    differ = tri_r != tri_k
    if not bool(differ.any()):
        return 0
    d = rays[differ]
    cache = FixedOriginCache.build(o, tris)
    orc = mt_fixed_origin(d, cache, cfg.draw_distance, cfg.eps, chunk=16384)

    def t_of(ids):   # each id's t by the oracle's constants; inf on a miss
        t = (cache.tdet[ids.clamp_min(0).long()]
             / (d * cache.m_det[ids.clamp_min(0).long()]).sum(dim=1))
        return torch.where(ids >= 0, t, torch.inf)
    tr, tk = t_of(tri_r[differ]), t_of(tri_k[differ])
    rel = torch.maximum((tr - orc.t).abs(), (tk - orc.t).abs()) / orc.t
    tie = (orc.tri >= 0) & (rel <= 1e-5)
    raster_right = tri_r[differ] == orc.tri
    rows = zip(differ.nonzero().squeeze(1).tolist(), tri_r[differ].tolist(),
               tr.tolist(), tri_k[differ].tolist(), tk.tolist(),
               orc.tri.tolist(), orc.t.tolist(), tie.tolist(),
               raster_right.tolist())
    for at, a, t_a, b, t_b, ot, o_t, is_tie, right in rows:
        log(f"  ray {at}: raster triangle {a} t {t_a!r}, K1 triangle {b} t "
            f"{t_b!r}, oracle triangle {ot} t {o_t!r}: "
            + ("an oracle tie" if is_tie else "raster is the oracle's"
               if right else "NEITHER"))
    if not bool((tie | raster_right).all()):
        raise RuntimeError("raster and K1 differ where the oracle sees no "
                           "tie and the raster id is not the oracle's")
    return int((~tie & raster_right).sum())


def run_raster(dev, frames, outs, idx_t, ref, smi):
    """Phase 13 (see the module docstring): the raster path (plain
    PyTorch, no kernel) on headline frame 0."""
    from cpp_cuda_raytracer_dev_torch import RenderConfig, render
    from cpp_cuda_raytracer_dev_torch.accel.raster import intersect_raster

    scene, cam = frames[0]
    obj = scene.objects[0]
    rcfg = RenderConfig(method="raster")
    with torch.inference_mode():
        render(scene, cam, rcfg)                          # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ms = []
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for _ in range(RASTER_FRAMES):
            start.record()
            out = render(scene, cam, rcfg)
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        peak = torch.cuda.max_memory_allocated() - base
        _, stats = intersect_raster(
            obj.pose.inv_apply(cam.pos),
            obj.pose.inv_apply_vec(cam.ray_directions()), obj.tris,
            cam.projection().transformed(obj.pose),
            dataclasses.replace(rcfg, with_stats=True), RES_H, RES_W)
        got = out.hit_tri.reshape(-1)[idx_t]
        agree = float((got == ref.tri).float().mean())
        differ = int((out.hit_tri != outs[0].hit_tri).sum())
        log(f"raster frame 0: median {float(np.median(ms)):.3f} ms "
            f"{[round(x, 3) for x in ms]}, peak memory above the scene "
            f"{peak / 2**20:.1f} MiB; stats {stats}; oracle agreement "
            f"{agree:.6f} on {N_SAMPLE} rays; ids differ from K1's frame on "
            f"{differ} of {out.hit_tri.numel()} rays; hit rate "
            f"{float((out.hit_tri >= 0).float().mean()):.6f} ({smi})")
        if stats["overflow"] != 0:
            raise RuntimeError("the raster path dropped geometry")
        # frame 0's pose is the identity: the world frame is the object's
        k1_wrong = check_raster_against_k1(
            out.hit_tri.reshape(-1), outs[0].hit_tri.reshape(-1),
            cam.ray_directions(), cam.pos, obj.tris, rcfg)
        log(f"raster vs K1: {differ} rays differ, {k1_wrong} of them rays "
            f"where K1 is not the oracle's and raster is (ROADMAP F2), the "
            f"rest oracle ties")
        # a wider span moves triangles from the dense pass to the scatter
        for span in RASTER_SPANS:
            c = dataclasses.replace(rcfg, raster_span=span, with_stats=True)
            start.record()
            hit, st = intersect_raster(
                obj.pose.inv_apply(cam.pos),
                obj.pose.inv_apply_vec(cam.ray_directions()), obj.tris,
                cam.projection().transformed(obj.pose), c, RES_H, RES_W)
            end.record()
            torch.cuda.synchronize()
            log(f"raster at span {span}: {start.elapsed_time(end):.3f} ms "
                f"(one call, with its stats' host reads), stats {st}; ids "
                f"equal to span {rcfg.raster_span}'s "
                f"{torch.equal(hit.tri, out.hit_tri.reshape(-1))} ({smi})")
    if agree < MIN_AGREE:
        raise RuntimeError(f"raster agreement {agree} < {MIN_AGREE}")


def run_f64(dev):
    """Phase 14 (see the module docstring): float64 on the card."""
    from cpp_cuda_raytracer_dev_torch import (Camera, RenderConfig, Scene,
                                              SceneObject, Triangles, render,
                                              render_differentiable)
    from cpp_cuda_raytracer_dev_torch.ops.intersect import mt_brute
    from cpp_cuda_raytracer_dev_torch.utils.dtypes import F32, F64
    from cpp_cuda_raytracer_dev_torch.utils.procgen import uv_sphere

    tv = uv_sphere(24, 24)
    tv = np.roll(tv, -tv.shape[0] // 2, axis=0)

    def world(dtype):
        return (Scene([SceneObject(Triangles.from_vertices(
            tv, device=dev, dtype=dtype))]),
            Camera.create(96, 64, pos=[0.1, 0.3, -3.0],
                          look_at=[0.0, 0.0, 0.0], up=[0.0, 1.0, 0.0],
                          film_h=0.024, focal=0.055, device=dev, dtype=dtype))
    for method in ("brute", "fixed"):
        c = RenderConfig(method=method, chunk=256)
        out64 = render(*world(F64.fp), c)
        out32 = render(*world(F32.fp), c)
        dtypes = {f: getattr(out64, f).dtype for f in ("radiance", "hit_t")}
        same = (out64.hit_tri == out32.hit_tri).float().mean()
        log(f"float64 {method} on the card: dtypes {dtypes}, finite "
            f"{bool(torch.isfinite(out64.radiance).all())}, ids equal to "
            f"float32's on {float(same):.6f} of the pixels")
        if set(dtypes.values()) != {torch.float64} or float(same) < 0.98 \
                or not bool(torch.isfinite(out64.radiance).all()):
            raise RuntimeError(f"float64 {method} frame")
    # the analytic ray: t = 3 exactly
    tri = np.array([[[-1, -1, 2], [1, -1, 2], [-1, 1, 2]]], np.float64)
    with torch.no_grad():
        errs = {str(dt): abs(float(mt_brute(
            torch.tensor([-0.1, -0.1, -1.0], dtype=dt, device=dev),
            torch.tensor([[0.0, 0.0, 1.0]], dtype=dt, device=dev),
            Triangles.from_vertices(tri, device=dev, dtype=dt),
            chunk=1).t[0]) - 3.0) for dt in (F64.fp, F32.fp)}
    scene, cam = world(F64.fp)
    cam.pos.requires_grad_(True)
    render_differentiable(scene, cam, RenderConfig(
        method="fixed", chunk=256)).radiance.mean().backward()
    g = cam.pos.grad
    refused = []
    for method in ("bin", "raster"):
        try:
            render(scene, cam, RenderConfig(method=method))
        except TypeError:
            refused.append(method)
    log(f"float64 analytic ray |t - 3|: {errs}; d mean radiance / d cam "
        f"pos {g.tolist()} ({g.dtype}); float64 refused by {refused}")
    if errs[str(F64.fp)] > 1e-12 or g.dtype != torch.float64 \
            or not bool(torch.isfinite(g).all()) or len(refused) != 2:
        raise RuntimeError("float64 on the card")


FIELDS = ("hit_t", "hit_tri", "hit_obj", "image", "radiance", "normal",
          "point")


def differ(a, b):
    """The output fields in which two frames are not bitwise equal."""
    return [f for f in FIELDS if not torch.equal(getattr(a, f),
                                                 getattr(b, f))]


def spread(v):
    return (f"median {float(np.median(v)):.3f} ms, min {min(v):.3f}, max "
            f"{max(v):.3f} {[round(x, 3) for x in v]}")


def jit_frames(method, c, acc, kname, frames, smi, note="", mesh=None):
    """`render_jit` against `render` for one method (with a mesh,
    `render_sharded_jit` against `render_sharded` under inference mode):
    frames 0, 1 and 0 bitwise, one graph captured, eager and replayed
    frames timed in turns and one of each profiled; ``kname`` must be seen
    inside the replay, and K11's counter must move in the capture (K13's,
    a step's backward, must not). Returns {kernel: instances in the replayed
    frame} (`KERNEL_NAMES`)."""
    from cpp_cuda_raytracer_dev_torch import render, render_jit
    from cpp_cuda_raytracer_dev_torch.models import renderer
    from cpp_cuda_raytracer_dev_torch.ops.cuda import shade as k10
    from cpp_cuda_raytracer_dev_torch.parallel import render_pjit as pj

    name = "render_jit"
    cache, fns = renderer.FRAME_GRAPHS, {"eager": render,
                                         "replayed": render_jit}
    if mesh is not None:
        name = "render_sharded_jit"
        cache = pj.sharded_graphs(mesh)

        def eager(scene, cam, config, accel):
            with torch.inference_mode():
                return pj.render_sharded(scene, cam, config, mesh, accel)
        fns = {"eager": eager, "replayed": lambda scene, cam, config, accel:
               pj.render_sharded_jit(scene, cam, config, mesh, accel)}
    captures, regrown = cache.captures, cache.regrown
    k13 = k10.frame_setup_grad.launches
    bad, k11 = [], 0
    for i in (0, 1, 0):          # frame 0, another camera and pose, frame 0
        before = k10.frame_setup.launches
        got = fns["replayed"](*frames[i], c, acc)
        k11 += k10.frame_setup.launches - before
        bad += [f"frame {i} {f}" for f in
                differ(got, fns["eager"](*frames[i], c, acc))]
    torch.cuda.synchronize()
    ms = in_turns(lambda kind, i: fns[kind](*frames[i % N_FRAMES], c, acc),
                  ("eager", "replayed"), N_PAIRED)
    prof = {k: replay_profile(lambda: f(*frames[0], c, acc))
            for k, f in fns.items()}
    log(f"{name} {method}: bitwise the eager frames 0, 1, 0 "
        f"{not bad}; K11 launches in the capture {k11}, K13 launches "
        f"{k10.frame_setup_grad.launches - k13}; graphs captured "
        f"{cache.captures - captures}, "
        f"regrowths {cache.regrown - regrown}{note}; "
        + "; ".join(f"{k} frames {spread(v)}, profiled frame: device "
                    f"busy {prof[k][0]:.3f} ms in {prof[k][1]} device "
                    f"operations, {prof[k][2]} host operations "
                    f"({prof[k][4]} graph launches), kernels seen "
                    f"{prof[k][3]}" for k, v in ms.items())
        + f" ({smi})")
    if mesh is not None:
        log(f"{name} {method}, the replayed frame's host operations: "
            f"{prof['replayed'][5]}")
    if bad:
        raise RuntimeError(f"{name} {method} differs from the eager frame: "
                           f"{bad}")
    # one graph; with a mesh, one more for each regrowth (a band's agreed
    # bucket may be outgrown by frame 1)
    grown = cache.regrown - regrown
    if cache.captures - captures != 1 + grown or (mesh is None and grown):
        raise RuntimeError(f"{name} {method} captured "
                           f"{cache.captures - captures} graphs in "
                           f"{grown} regrowths")
    seen = prof["replayed"][3]
    if min(seen[kname], prof["replayed"][4], k11) < 1 \
            or k10.frame_setup_grad.launches != k13:
        raise RuntimeError(f"{kname} not seen inside the replayed {method} "
                           f"frame, or K11 not captured in it ({k11})")
    return seen


def headline_configs() -> dict:
    """The headline's configurations by method: "bin" (every phase), and
    "pallas2" and "pallas" with their ClusterAccel's leaf size (phase 9
    on)."""
    from cpp_cuda_raytracer_dev_torch import RenderConfig
    c2 = RenderConfig(method="pallas2", leaf_size=128, tile_h=16, tile_w=32,
                      max_candidates=64, group_size=32, max_groups=24,
                      escalate_tiles=64, escalate_factor=4)
    return {"bin": RenderConfig(method="bin", tile_h=16, tile_w=32,
                                bin_chunk=512, backface_cull=True),
            "pallas2": c2,
            "pallas": dataclasses.replace(c2, method="pallas")}


def headline_frames(dev, headline_tv) -> list:
    """The headline's `N_FRAMES` (scene, camera) pairs, one Triangles for
    all: frame i turns the mesh by 2·i degrees and moves the camera by
    0.002·i."""
    from cpp_cuda_raytracer_dev_torch import (Camera, Pose, Scene,
                                              SceneObject, Triangles)
    from cpp_cuda_raytracer_dev_torch.ops.quaternion import from_axis_angle
    tris = Triangles.from_vertices(headline_tv, device=dev)
    frames = []
    for i in range(N_FRAMES):
        pose = Pose(from_axis_angle([0.0, 1.0, 0.0], math.radians(2.0 * i),
                                    device=dev), torch.zeros(3, device=dev))
        cam = Camera.create(RES_W, RES_H, pos=[0.002 * i, 0.0, -3.0],
                            look_at=[0.0, 0.0, 0.0], up=[0.0, 1.0, 0.0],
                            film_h=0.024, focal=0.055, device=dev)
        frames.append((Scene([SceneObject(tris, pose)]), cam))
    return frames


def kd_tables(dev, tv, leaf=KD_LEAF, dtype=torch.float32, tree=None):
    """KD tables of the vertices ``tv`` (a native tree at ``leaf``, or
    ``tree``), the geometry in ``dtype``."""
    from cpp_cuda_raytracer_dev_torch import KDTables, Triangles
    from cpp_cuda_raytracer_dev_torch.accel.native import build_kd_fast
    if tree is None:
        tree = build_kd_fast(tv.min(axis=1), tv.max(axis=1), leaf)
    return KDTables.from_tree(tree, Triangles.from_vertices(
        tv, device=dev, dtype=dtype))


def train_set(dev, headline_tv):
    """Parameters of the headline training step: the mesh under a pose
    turned by 1 degree, the bench camera, every leaf trainable."""
    from cpp_cuda_raytracer_dev_torch import (Camera, Pose, Scene,
                                              SceneObject, Triangles)
    from cpp_cuda_raytracer_dev_torch.ops.quaternion import from_axis_angle
    tris = Triangles.from_vertices(headline_tv, device=dev)
    pose = Pose(from_axis_angle([0.0, 1.0, 0.0], math.radians(1.0),
                                device=dev), torch.zeros(3, device=dev))
    cam = Camera.create(RES_W, RES_H, pos=[0.0, 0.0, -3.0],
                        look_at=[0.0, 0.0, 0.0], up=[0.0, 1.0, 0.0],
                        film_h=0.024, focal=0.055,
                        device=dev).requires_grad_()
    return {"scene": Scene([SceneObject(tris, pose)]), "camera": cam}


def jit_steps(dev, headline_tv, c, acc, kname, target, smi, mesh=None,
              turns=N_PAIRED // 2):
    """The compiled all-leaves and pose/light/camera-only steps
    (`make_train_step_jit`) against the eager ones from twin parameter
    sets, both with ``mesh``: parameters and losses bitwise after
    `N_JIT_STEPS` steps and after ``turns`` of each in turns and the
    profiled ones; ``kname`` seen in every replayed step, K2 in the
    all-leaves one only, K8 and K9 in every bin step, K10 and K12 in every
    step and K11 in none.
    Returns {kernel name: instances in the replayed all-leaves step} for
    ``kname``, K2 and `SERVING_KERNELS`."""
    from cpp_cuda_raytracer_dev_torch.parallel.render_pjit import (
        make_train_step, make_train_step_jit)

    def leaves(p):
        return [*p["scene"].parameters(), *p["camera"].parameters()]

    sets = {"compiled": train_set(dev, headline_tv),
            "eager": train_set(dev, headline_tv)}
    makers = {"compiled": make_train_step_jit, "eager": make_train_step}
    out = {}
    for kind in ("all-leaves", "pose/light/camera-only"):
        if kind != "all-leaves":
            for p in sets.values():
                p["scene"].objects[0].tris.requires_grad_(False)
                p["camera"].requires_grad_(False)
                p["camera"].pos.requires_grad_(True)
        opts = {k: torch.optim.SGD(
            leaves(p) if kind == "all-leaves" else
            [*p["scene"].objects[0].pose.parameters(),
             *p["scene"].phong.parameters(), p["camera"].pos], lr=LR)
            for k, p in sets.items()}
        steps = {k: makers[k](opts[k], c, mesh, acc) for k in sets}

        def run(k, _i=0):
            return steps[k](sets[k], target)
        losses = {k: [float(run(k)) for _ in range(N_JIT_STEPS)]
                  for k in sets}
        same = all(torch.equal(a, b) for a, b in
                   zip(leaves(sets["compiled"]), leaves(sets["eager"])))
        ms = in_turns(run, ("eager", "compiled"), turns)
        prof = {k: replay_profile(lambda: run(k)) for k in sets}
        same_after = all(torch.equal(a, b) for a, b in
                         zip(leaves(sets["compiled"]), leaves(sets["eager"])))
        log(f"{c.method} {kind} steps{'' if mesh is None else ' sharded'}, "
            f"compiled against eager: losses "
            f"{losses['compiled']} / {losses['eager']}, parameters bitwise "
            f"equal after {N_JIT_STEPS} steps {same}, after the timed and "
            f"profiled ones {same_after}; "
            + "; ".join(f"{k} steps {spread(v)}, profiled step: device busy "
                        f"{prof[k][0]:.3f} ms in {prof[k][1]} device "
                        f"operations, {prof[k][2]} host operations "
                        f"({prof[k][4]} graph launches), kernels seen "
                        f"{prof[k][3]}" for k, v in ms.items())
            + f" ({smi})")
        if mesh is not None:
            log(f"the compiled sharded {kind} step's host operations: "
                f"{prof['compiled'][5]}")
        if not (same and same_after) or losses["compiled"] != losses["eager"]:
            raise RuntimeError(f"the compiled {c.method} {kind} step differs "
                               "from the eager step")
        seen = prof["compiled"][3]
        k2_seen = seen["segment_sum"]
        all_leaves = kind == "all-leaves"
        if seen[kname] < 1 or (k2_seen > 0) != all_leaves \
                or prof["compiled"][4] < 1:
            raise RuntimeError(f"the replayed {c.method} {kind} step ran "
                               f"{kname} {seen[kname]} and K2 {k2_seen} times")
        # K8 and K9 in a bin step, K10 and K12 in every step (the
        # shading's forward and backward), K11 and K13 too (the set-up's)
        if not seen["shade_compose"] or not seen["shade_grad"] \
                or not seen["frame_setup"] or not seen["frame_setup_grad"] \
                or (c.method == "bin") != (
                seen["bin_tri_pass"] > 0 and seen["bin_entry_keys"] > 0):
            raise RuntimeError(f"the replayed {c.method} {kind} step ran "
                               f"the serving kernels {seen}")
        if all_leaves:
            out = {kname: seen[kname], "segment_sum": k2_seen,
                   **{k: seen[k] for k in (*SERVING_KERNELS, "shade_grad",
                                           "frame_setup_grad")}}
        del steps, opts
    return out


def run_jit(dev, headline_tv, frames, cfg, accel, ccfgs, target, smi):
    """Phase 15 (see the module docstring): `render_jit` and
    `make_train_step_jit` at the headline size. Returns {kernel name:
    {"serve_jit": n, "train_jit": n}} for the kernels line: the kernel's
    instances the profiler saw in one replayed frame of its method and in
    one replayed all-leaves step. The wrappers' counters count a graph's
    capture (and its warm-up), not its replays."""
    from cpp_cuda_raytracer_dev_torch import Camera, render, render_jit
    from cpp_cuda_raytracer_dev_torch.models import renderer
    from cpp_cuda_raytracer_dev_torch.models.renderer import bin_entry_count
    from cpp_cuda_raytracer_dev_torch.utils.graphs import next_bucket

    cache = renderer.FRAME_GRAPHS
    out = {}
    live0 = bin_entry_count(*frames[0], cfg)
    bucket = next_bucket(live0, cfg.bin_chunk)
    cases = {"bin": (cfg, None, "bin_intersect"),
             "pallas2": (ccfgs["pallas2"], (accel,), "tile_intersect_v2"),
             "pallas": (ccfgs["pallas"], (accel,), "tile_intersect")}
    for method, (c, acc, kname) in cases.items():
        note = (f", frame 0's bucket {bucket} for {live0} live entries"
                if method == "bin" else "")
        out[kname] = {"serve_jit": jit_frames(method, c, acc, kname, frames,
                                              smi, note)[kname]}

    # growth: a camera moved nearer until its live count outgrows frame 0's
    # bucket; the frame is captured again at a larger one and stays bitwise
    scene = frames[0][0]
    for z in (-2.5, -2.2, -2.0, -1.8, -1.6, -1.4, -1.2, -1.0):
        near = Camera.create(RES_W, RES_H, pos=[0.0, 0.0, z],
                             look_at=[0.0, 0.0, 0.0], up=[0.0, 1.0, 0.0],
                             film_h=0.024, focal=0.055, device=dev)
        live = bin_entry_count(scene, near, cfg)
        if live > bucket:
            break
    else:
        raise RuntimeError(f"no nearer camera outgrows the bucket {bucket}")
    regrown, captures = cache.regrown, cache.captures
    bad = differ(render_jit(scene, near, cfg), render(scene, near, cfg))
    bad += differ(render_jit(*frames[0], cfg), render(*frames[0], cfg))
    log(f"render_jit growth: camera at z {z} has {live} live entries above "
        f"frame 0's bucket {bucket}; regrown {cache.regrown - regrown}, "
        f"graphs captured {cache.captures - captures}, bitwise render's "
        f"(that camera, then frame 0 at the new bucket) {not bad}")
    if bad or cache.regrown != regrown + 1 or \
            cache.captures != captures + 1:
        raise RuntimeError(f"growth failed: {bad}")

    # the compiled steps against the eager ones, from twin parameter sets
    seen = jit_steps(dev, headline_tv, cfg, None, "bin_intersect", target,
                     smi)
    out["bin_intersect"]["train_jit"] = seen["bin_intersect"]
    out["segment_sum"] = {"serve_jit": 0, "train_jit": seen["segment_sum"]}
    for k in (*SERVING_KERNELS, "shade_grad", "frame_setup_grad"):
        out[k] = {"train_jit": seen[k]}
    return out


def grid_mesh(n: int = 8) -> np.ndarray:
    """A height field of n x n quads over [-1, 1]^2 whose vertices lie on
    exact binary fractions (x = 0 and y = 0 among them), so that split
    planes and box faces fall exactly on `axis_rays`, in front of a small
    sphere."""
    from cpp_cuda_raytracer_dev_torch.utils.procgen import uv_sphere
    xs = np.linspace(-1.0, 1.0, n + 1)

    def v(i, j):
        return (xs[i], xs[j], 0.125 * ((i + 2 * j) % 3))
    tv = []
    for i in range(n):
        for j in range(n):
            tv.append([v(i, j), v(i + 1, j), v(i, j + 1)])
            tv.append([v(i + 1, j + 1), v(i, j + 1), v(i + 1, j)])
    sphere = uv_sphere(12, 12) * 0.5 + np.array([0.0, 0.0, -1.0])
    return np.concatenate([np.asarray(tv, np.float32), sphere])


def axis_rays(dtype, dev):
    """Directions with a zero component ((0, s, 1), (s, 0, 1), the six
    axes), normalised: on a box plane through the origin the slab test
    meets 0 * inf = NaN."""
    s = np.linspace(-0.4, 0.4, 33)
    d = np.array([(0.0, v, 1.0) for v in s] + [(v, 0.0, 1.0) for v in s]
                 + [(0, 0, 1), (1, 0, 0), (0, 1, 0), (-1, 0, 0), (0, -1, 0),
                    (0, 0, -1), (0, 0.2, 0.9), (0.3, 0, 0.8)], np.float64)
    return torch.tensor(d / np.linalg.norm(d, axis=1, keepdims=True),
                        dtype=dtype, device=dev)


def tilted_plane(normal, n: int = 30):
    """(tv, u, v, unit normal): n x n quads over [-1, 1]^2 of the plane
    through 0 with that normal, spanned by the unit vectors u and v."""
    nrm = np.asarray(normal, np.float64)
    nrm /= np.linalg.norm(nrm)
    u = np.cross(nrm, [0.0, 0.0, 1.0])
    u /= np.linalg.norm(u)
    v = np.cross(nrm, u)
    xs = np.linspace(-1.0, 1.0, n + 1)
    tv = []
    for i in range(n):
        for j in range(n):
            a, b = xs[i] * u + xs[j] * v, xs[i + 1] * u + xs[j] * v
            c, d = xs[i] * u + xs[j + 1] * v, xs[i + 1] * u + xs[j + 1] * v
            tv += [[a, b, c], [b, d, c]]
    return np.asarray(tv, np.float32), u, v, nrm


def tilted_rays(u, v, nrm, angle, dtype, dev, n=1500):
    """(o, d): rays from 3 units off the plane's edge, ``angle`` radians
    above it, to seeded points of the plane."""
    rng = np.random.default_rng(1)
    o = -3.0 * v + 0.013 * u + 3.0 * np.tan(angle) * nrm
    a, b = rng.uniform(-0.9, 0.9, (2, n))
    d = a[:, None] * u + b[:, None] * v - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.tensor(o, dtype=dtype, device=dev),
            torch.tensor(d, dtype=dtype, device=dev))


def run_kd(dev, headline_tv, frames, idx_t, ref, target, smi, clock_mhz):
    """Phase 16 (see the module docstring): K7 against its plain version,
    timed with its bound; kd frames served through `render`, through
    `render_jit`; the compiled kd steps; the compiled raster step, which
    runs uncaptured. Returns K7's entry of the kernels line (with
    ``k2_train_jit``, K2's instances in the replayed kd step, to move)."""
    from cpp_cuda_raytracer_dev_torch import Camera, RenderConfig, render
    from cpp_cuda_raytracer_dev_torch.accel.native import build_kd_fast
    from cpp_cuda_raytracer_dev_torch.accel.traverse import kd_intersect
    from cpp_cuda_raytracer_dev_torch.ops.cuda import kd_traverse as k7
    from cpp_cuda_raytracer_dev_torch.ops.cuda.kd_traverse import \
        kd_traverse_reference
    from cpp_cuda_raytracer_dev_torch.parallel.render_pjit import (
        make_train_step, make_train_step_jit)
    from cpp_cuda_raytracer_dev_torch.utils.procgen import uv_sphere

    def tables(tv, leaf, dtype=torch.float32, tree=None):
        return kd_tables(dev, tv, leaf, dtype, tree)

    draw, eps = RenderConfig().draw_distance, RenderConfig().eps
    no_exit = k7.DESIGN & ~k7.LEVERS["near_first"]
    max_err = 0.0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def hold(name, o, d, tab, width=0, chunk=32768, counts=None,
             graze=False):
        """K7 against the plain version on the same rays, t, ids and object
        ids bitwise: the design (`kd_intersect`) against the near-first
        walk, K7 with the exit switched off against the walk without it,
        and the two walks against each other (the exit's exactness; with
        ``graze``, rays more grazing than the exit's proven bound, the
        rays where the walks differ are counted, not held). With
        ``counts`` the walks add their counts to ``counts["near_first"]``
        and ``counts["no_exit"]``. Returns (K7's hit, the near-first plain
        version's ms)."""
        counts = counts or {}
        nonlocal max_err
        launches = k7.kd_traverse.launches
        got = kd_intersect(o, d, tab, width=width)
        torch.cuda.synchronize()
        if k7.kd_traverse.launches != launches + 1:
            raise RuntimeError("kd_intersect did not launch K7 once")
        t_off, tri_off = k7._launch(o, d, tab, draw, eps, width, no_exit)
        start.record()
        want_t, want_tri = kd_traverse_reference(
            o, d, tab, draw, eps, chunk, counts.get("near_first"))
        end.record()
        torch.cuda.synchronize()
        want_obj = torch.where(want_tri >= 0, 0, -1).to(torch.int32)
        old_t, old_tri = kd_traverse_reference(
            o, d, tab, draw, eps, chunk, counts.get("no_exit"),
            near_first=False)
        same = {"K7": torch.equal(got.t, want_t)
                and torch.equal(got.tri, want_tri)
                and torch.equal(got.obj, want_obj),
                "K7 without the exit": torch.equal(t_off, old_t)
                and torch.equal(tri_off, old_tri),
                "the walks": torch.equal(want_t, old_t)
                and torch.equal(want_tri, old_tri)}
        err = max(float((got.t - want_t).abs().max()),
                  float((t_off - old_t).abs().max()))
        max_err = max(max_err, err)
        apart = (want_t != old_t) | (want_tri != old_tri)
        log(f"K7 vs plain [{name}]: rays {d.shape[0]} depth "
            f"{tab.max_depth} widest leaf {tab.max_leaf}; bitwise: K7 and "
            f"the near-first walk {same['K7']}, K7 without the exit and the "
            f"walk without it {same['K7 without the exit']}, the two walks "
            f"{same['the walks']} (rays apart {int(apart.sum())}, ids apart "
            f"{int((want_tri != old_tri).sum())}, largest t apart "
            f"{float((want_t - old_t).abs().where(apart, 0).amax())}); "
            f"max_abs_err {err} hit_rate "
            f"{float((got.tri >= 0).float().mean()):.6f}")
        if graze:
            same.pop("the walks")
        if not all(same.values()):
            raise RuntimeError(f"K7 and its plain version disagree on {name}: "
                               f"{same}")
        return got, start.elapsed_time(end)

    def time_levers(o, d, tab, width):
        """{"design" or "no x", the design with lever x off: [ms]}: the
        mean of `K7_LEVER_REPS` launches a sample, the variants in turns
        (ABBA), `K7_LEVER_ROUNDS` samples each."""
        masks = {"design": k7.DESIGN,
                 **{f"no {k}": k7.DESIGN & ~v for k, v in k7.LEVERS.items()}}
        ms = {k: [] for k in masks}
        for i in range(K7_LEVER_ROUNDS):
            for k in (list(masks) if i % 2 == 0 else list(masks)[::-1]):
                k7._launch(o, d, tab, draw, eps, width, masks[k])
                start.record()
                for _ in range(K7_LEVER_REPS):
                    k7._launch(o, d, tab, draw, eps, width, masks[k])
                end.record()
                torch.cuda.synchronize()
                ms[k].append(start.elapsed_time(end) / K7_LEVER_REPS)
        return ms

    sphere = uv_sphere(50, 50)
    for dtype in (torch.float32, torch.float64):
        cam = Camera.create(96, 64, pos=[0.0, 0.0, -3.0],
                            look_at=[0.0, 0.0, 0.0], up=[0.0, 1.0, 0.0],
                            film_h=0.024, focal=0.055, device=dev,
                            dtype=dtype)
        with torch.no_grad():
            o, d = cam.pos.detach().clone(), cam.ray_directions()
        for name, tv in (("sphere", sphere),
                         ("duplicated-triangle ties",
                          np.concatenate([sphere, sphere]))):
            for leaf in (1, 8, 128):
                hold(f"{name} 96x64 leaf {leaf} {dtype}", o, d,
                     tables(tv, leaf, dtype), 96)
        grid = grid_mesh()
        for leaf in (1, 4, 128):
            tab = tables(grid, leaf, dtype)
            for pos in ((0.0, 0.0, -3.0), (0.25, -0.5, -2.0)):
                hold(f"axis-aligned rays from {pos} leaf {leaf} {dtype}",
                     torch.tensor(pos, dtype=dtype, device=dev),
                     axis_rays(dtype, dev), tab)
        angles = (1e-4, 1e-3) if dtype == torch.float32 else (1e-12, 1e-10)
        for normal in ((0.57, 0.61, -0.55), (0.3, 0.9, 0.2)):
            tv, u, v, nrm = tilted_plane(normal)
            for leaf in (1, 8):
                tab = tables(tv, leaf, dtype)
                for angle in angles:
                    hold(f"rays grazing the plane of normal {normal} at "
                         f"{angle} rad, leaf {leaf} {dtype}",
                         *tilted_rays(u, v, nrm, angle, dtype, dev), tab)
        if dtype == torch.float32:
            # below the exit's proven bound (ops/cuda/kd_traverse.py
            # NEAR_REL): the walks may differ there; counted, not held
            tv, u, v, nrm = tilted_plane((0.57, 0.61, -0.55))
            hold(f"rays grazing the plane of normal (0.57, 0.61, -0.55) at "
                 f"1e-05 rad, below the exit's bound, leaf 1 {dtype}",
                 *tilted_rays(u, v, nrm, 1e-5, dtype, dev, 3000),
                 tables(tv, 1, dtype), graze=True)

    # headline frame 0 at 960x540, leaf 128: every ray, in float32 and (the
    # same rays widened) in float64
    t0 = time.perf_counter()
    tree = build_kd_fast(headline_tv.min(axis=1), headline_tv.max(axis=1),
                         KD_LEAF)
    kd_tab = tables(headline_tv, KD_LEAF, tree=tree)
    build_s = time.perf_counter() - t0
    kd_tab64 = tables(headline_tv, KD_LEAF, torch.float64, tree=tree)
    scene, cam = frames[0]
    obj = scene.objects[0]
    with torch.no_grad():
        o = obj.pose.inv_apply(cam.pos)
        d = obj.pose.inv_apply_vec(cam.ray_directions())
    o64, d64 = o.double(), d.double()
    log(f"headline KD tables: leaf {KD_LEAF}, {kd_tab.node_link.shape[0]} "
        f"nodes, depth {kd_tab.max_depth}, widest leaf {kd_tab.max_leaf}, "
        f"built in {build_s:.2f} s")
    what = (f"headline frame 0 {RES_W}x{RES_H} leaf {KD_LEAF}, all "
            f"{d.shape[0]} rays, the plain version in runs of "
            f"{KD_PLAIN_CHUNK}")
    c32 = {"near_first": {}, "no_exit": {}}
    c64 = {"near_first": {}, "no_exit": {}}
    hit, plain_ms = hold(what, o, d, kd_tab, RES_W, KD_PLAIN_CHUNK, c32)
    _, plain_ms64 = hold(f"{what}, float64", o64, d64, kd_tab64, RES_W,
                         KD_PLAIN_CHUNK, c64)
    walks = {k: {c: int(v) for c, v in w.items()} for k, w in (
        ("near_first", c32["near_first"]), ("no_exit", c32["no_exit"]),
        ("near_first_f64", c64["near_first"]))}
    k7_ms = cuda_ms(lambda: kd_intersect(o, d, kd_tab, width=RES_W),
                    KERNEL_REPS)
    k7_ms64 = cuda_ms(lambda: kd_intersect(o64, d64, kd_tab64, width=RES_W),
                      KERNEL_REPS)
    n_nodes, n_tris = kd_tab.node_link.shape[0], kd_tab.perm.shape[0]
    bounds = {}
    for key, walk in walks.items():
        f64 = key.endswith("f64")
        wide = 8 if f64 else 4
        # rays in, t and ids out, the node tables and the slots (packed
        # geometry and perm) once
        n_bytes = (d.numel() * wide + 3 * wide + d.shape[0] * (wide + 4)
                   + n_nodes * 48 + n_tris * (12 * wide + 4))
        bounds[key] = op_bounds(walk["slab_tests"] * K7_OPS_PER_NODE
                                + walk["mt_pairs"] * K7_OPS_PER_PAIR,
                                n_bytes, clock_mhz,
                                FP64_LANES if f64 else FP32_LANES)
    per_ray = {k: {c: round(v / d.shape[0], 2) for c, v in w.items()}
               for k, w in walks.items()}
    log(f"K7 at the headline shapes ({d.shape[0]} rays, {n_tris} triangles, "
        f"leaf {KD_LEAF}): float32 {k7_ms:.4f} ms, float64 {k7_ms64:.4f} ms; "
        f"plain (the near-first walk, once, the bitwise runs) float32 "
        f"{plain_ms:.4f} ms, float64 {plain_ms64:.4f} ms, counting; the "
        f"walks' counts "
        f"(slab tests at {K7_OPS_PER_NODE} operations, MT pairs at "
        f"{K7_OPS_PER_PAIR}, skipped pops) {walks}, a ray {per_ray}; "
        + "; ".join(f"{k}: {b['text']}" for k, b in bounds.items())
        + f"; the float64 bound at the FP64 rate ({smi})")

    lever_med = {}
    for key, args in (("float32", (o, d, kd_tab)),
                      ("float64", (o64, d64, kd_tab64))):
        lever_ms = time_levers(*args, RES_W)
        lever_med[key] = {k: float(np.median(v)) for k, v in lever_ms.items()}
        log(f"K7's levers at headline frame 0, {key}, each switched against "
            f"the design (mask {k7.DESIGN}) in turns ({K7_LEVER_ROUNDS} "
            f"samples of {K7_LEVER_REPS} launches): "
            + "; ".join(f"{k} {spread(v)}" for k, v in lever_ms.items())
            + f" ({smi})")

    # kd frames through render, the counter from 0 (the main path)
    kcfg = RenderConfig(method="kd")
    acc = (kd_tab,)
    k7.kd_traverse.launches = 0
    frame_ms, outs = [], []
    for f in frames:
        start.record()
        outs.append(render(*f, kcfg, acc))
        end.record()
        torch.cuda.synchronize()
        frame_ms.append(start.elapsed_time(end))
    serve = k7.kd_traverse.launches
    got_tri = outs[0].hit_tri.reshape(-1)[idx_t]
    agree = float((got_tri == ref.tri).float().mean())
    same0 = torch.equal(outs[0].hit_tri.reshape(-1), hit.tri)
    log(f"kd frames through render: {spread(frame_ms)}; K7 launches "
        f"{serve} for {len(frames)} frames; frame 0's ids those of the "
        f"bitwise run {same0}; oracle agreement {agree:.6f} on {N_SAMPLE} "
        f"rays ({smi})")
    for i, out in enumerate(outs):
        for fld in ("radiance", "hit_t", "normal", "point"):
            if not bool(torch.isfinite(getattr(out, fld)).all()):
                raise RuntimeError(f"kd frame {i}: non-finite {fld}")
    if serve < len(frames) or agree < MIN_AGREE or not same0:
        raise RuntimeError("kd frames: K7 not launched a frame, or wrong hits")
    del outs

    serve_jit = jit_frames("kd", kcfg, acc, "kd_traverse", frames,
                           smi)["kd_traverse"]
    seen = jit_steps(dev, headline_tv, kcfg, acc, "kd_traverse", target, smi)

    # raster: make_train_step_jit runs it uncaptured, as make_train_step
    rcfg = RenderConfig(method="raster")
    sets = {"compiled": train_set(dev, headline_tv),
            "eager": train_set(dev, headline_tv)}
    losses, names = {}, {}
    for kind, make in (("compiled", make_train_step_jit),
                       ("eager", make_train_step)):
        p = sets[kind]
        step = make(torch.optim.SGD([*p["scene"].parameters(),
                                     *p["camera"].parameters()], lr=LR), rcfg)
        names[kind] = step.__qualname__
        losses[kind] = [float(step(p, target)) for _ in range(N_RASTER_STEPS)]
    same = all(torch.equal(a, b) for a, b in zip(
        [*sets["compiled"]["scene"].parameters(),
         *sets["compiled"]["camera"].parameters()],
        [*sets["eager"]["scene"].parameters(),
         *sets["eager"]["camera"].parameters()]))
    log(f"raster steps through make_train_step_jit ({names['compiled']}) "
        f"and make_train_step ({names['eager']}): losses "
        f"{losses['compiled']} / {losses['eager']}, parameters bitwise equal "
        f"after {N_RASTER_STEPS} steps {same}")
    if not same or losses["compiled"] != losses["eager"] \
            or names["compiled"] != names["eager"]:
        raise RuntimeError("the compiled raster step is not the eager step")
    del sets

    bound = bounds["near_first"]
    return {"name": "kd_traverse", "route": "cuda",
            "source": "cpp_cuda_raytracer_dev_torch/csrc/kd_traverse.cu",
            "replaces": "cpp_cuda_raytracer_dev_tpu/accel/traverse.py:876",
            "launches": serve, "max_abs_err": max_err, "ms": k7_ms,
            "plain_ms": plain_ms, "bound_ms": bound["bound_ms"],
            "bound_by": bound["bound_by"], "library_ms": None,
            "bound_issue_ms": bound["bound_issue_ms"],
            "ms_f64": k7_ms64, "plain_ms_f64": plain_ms64,
            "bound_ms_f64": bounds["near_first_f64"]["bound_ms"],
            "bound_issue_ms_f64": bounds["near_first_f64"]["bound_issue_ms"],
            "bound_issue_ms_no_exit": bounds["no_exit"]["bound_issue_ms"],
            "walks": walks, "levers_ms": lever_med,
            "launches_by_path": {"serve": serve, "serve_jit": serve_jit,
                                 "train_jit": seen["kd_traverse"]},
            "k2_train_jit": seen["segment_sum"]}


def kernel_ms(fn, name, reps=KERNEL_REPS):
    """Device ms of one instance of the kernel named ``name`` in ``fn()``:
    the profiler's mean device time of its instances over ``reps`` calls,
    after one warm-up call and `lead_in` (the wrapper's own small
    operations and the host's pace are left out; a record the profiler
    drops, as it sometimes does, only leaves the mean over fewer)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        lead_in()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    events = [a for a in prof.key_averages()
              if a.device_type == DeviceType.CUDA]
    lead_seen(events)
    ev = [a for a in events if name in a.key]
    n = sum(a.count for a in ev)
    if n < 1:
        raise RuntimeError(f"{name} not seen in {reps} calls")
    return sum(a.self_device_time_total for a in ev) / 1e3 / n


def graph_ms(fn, reps=KERNEL_REPS):
    """Device ms of ``fn()`` captured alone into a CUDA graph and replayed
    back to back (its device busy time, free of the host)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = cuda_ms(graph.replay, reps)
    del graph
    return ms


def run_serving_kernels(dev, headline_tv, frames, cfg, accel, ccfgs, target,
                        smi, clock_mhz):
    """Phase 17 (see the module docstring): kernels K8, K9, K10 and K11.
    Returns their rows of the kernels line (main() adds the sharded and
    app paths to ``launches_by_path``) and K12's launches in one eager bin
    training step, its counter at 0 before it."""
    import contextlib

    from cpp_cuda_raytracer_dev_torch import (Camera, Pose, RenderConfig,
                                              Scene, SceneObject, Triangles,
                                              render, render_jit)
    from cpp_cuda_raytracer_dev_torch.accel import binning, traverse
    from cpp_cuda_raytracer_dev_torch.accel.traverse import (_bin_meta,
                                                             _ray_table)
    from cpp_cuda_raytracer_dev_torch.models import camera as camera_mod
    from cpp_cuda_raytracer_dev_torch.models import renderer
    from cpp_cuda_raytracer_dev_torch.models.camera import (
        frame_setup_reference, set_up_frame)
    from cpp_cuda_raytracer_dev_torch.models.renderer import trace_rays
    from cpp_cuda_raytracer_dev_torch.models.setup_grad import \
        frame_setup_grad_reference
    from cpp_cuda_raytracer_dev_torch.models.shading import (
        shade_compose_reference, shade_hits)
    from cpp_cuda_raytracer_dev_torch.models.shade_grad import \
        shade_grad_reference
    from cpp_cuda_raytracer_dev_torch.ops.cuda import bin_prepass as bp
    from cpp_cuda_raytracer_dev_torch.ops.cuda import shade as k10
    from cpp_cuda_raytracer_dev_torch.ops.cuda.bin_intersect import \
        bin_intersect
    from cpp_cuda_raytracer_dev_torch.ops.quaternion import from_axis_angle
    from cpp_cuda_raytracer_dev_torch.ops.shade import compose_framebuffer
    from cpp_cuda_raytracer_dev_torch.parallel.render_pjit import (
        make_train_step, make_train_step_jit)
    from cpp_cuda_raytracer_dev_torch.utils.graphs import GraphCache
    from cpp_cuda_raytracer_dev_torch.utils.procgen import uv_sphere

    wrappers = {k: getattr(bp, k) for k in SERVING_KERNELS[:4]}
    wrappers["shade_compose"] = k10.shade_compose
    wrappers["frame_setup"] = k10.frame_setup
    th, tw, chunk = cfg.tile_h, cfg.tile_w, cfg.bin_chunk

    def cam_at(pos, w=RES_W, h=RES_H, dtype=torch.float32):
        return Camera.create(w, h, pos=list(pos), look_at=[0.0, 0.0, 0.0],
                             up=[0.0, 1.0, 0.0], film_h=0.024, focal=0.055,
                             device=dev, dtype=dtype)

    # ---- each kernel bitwise its plain version ----
    max_err = {"K8": 0.0, "K9": 0.0, "K10": 0.0, "K11": 0.0}

    def same(kname, name, a, b, bad):
        if a.dtype.is_floating_point and a.shape == b.shape and a.numel():
            err = float((a.double() - b.double()).abs().nan_to_num(
                float("inf")).max())
            max_err[kname] = max(max_err[kname], err)
        if not torch.equal(a, b):
            bad.append(f"{kname} {name}")

    def hold_prepass(case, o, tris, proj, c, res_h, res_w, capacity=None):
        """K8 (both launches) and K9 (both) against their plain versions
        on one object's operands; returns the operands."""
        h2, w2 = _bin_meta(c, res_h, res_w)[:2]
        n_tx, n_tiles = w2 // tw, (h2 // th) * (w2 // tw)
        dbits = 31 - n_tiles.bit_length()
        bad = []
        with torch.inference_mode():
            args = (proj.band_local(), o, (tris.p1x, tris.p1y, tris.p1z),
                    (tris.e1x, tris.e1y, tris.e1z),
                    (tris.e2x, tris.e2y, tris.e2z), h2, w2, th, tw, c.eps,
                    c.backface_cull)
            tp = bp.bin_tri_pass(*args)
            tr = bp.bin_tri_pass_reference(*args)
            for f in ("ntiles", "tinfo", "ftab", "stats", "cross_tris"):
                same("K8", f, getattr(tp, f), getattr(tr, f), bad)
            rt = (proj, o, tp.stats, n_tiles, n_tx, th, tw, c.draw_distance)
            rays = bp.ray_table(*rt)
            same("K8", "ray table", rays, _ray_table(
                proj, o, tp.stats[:3], tp.stats[3:6], *rt[3:]), bad)
            cum = torch.cumsum(tp.ntiles, 0)
            live = int(cum[-1])
            size = live if capacity is None else capacity
            kk = (cum, tp, n_tiles, n_tx, size, dbits)
            keys = bp.bin_entry_keys(*kk)
            for n, a, b in zip(("key", "tri", "qstep"), keys,
                               bp.bin_entry_keys_reference(*kk)):
                same("K9", n, a, b, bad)
            key, order = torch.sort(keys[0], stable=True)
            e_pad = -(-size // chunk) * chunk + chunk
            tt = (key, order, keys[1], tp.ftab, n_tiles, dbits, e_pad)
            table = bp.bin_entry_table(*tt)
            for n, a, b in zip(("geom", "entry_tri", "starts"), table,
                               bp.bin_entry_table_reference(*tt)):
                same("K9", n, a, b, bad)
            torch.cuda.synchronize()
        log(f"K8, K9 against their plain versions [{case}]: "
            f"{tris.p1x.shape[0]} triangles, {live} live entries in a table "
            f"of {size}, "
            f"{int(tp.cross_tris)} crossing the camera plane; bitwise "
            f"{not bad}")
        if bad:
            raise RuntimeError(f"{case}: {bad} differ from the plain versions")
        return dict(args=args, rt=rt, kk=kk, tt=tt, tp=tp, rays=rays,
                    keys=keys[0], table=table, live=live, size=size,
                    n_tiles=n_tiles)

    def hold_shade(case, scene, cam, c, acc=None, band=None):
        """K10 against its plain version on a frame's hits (``band``: the
        rows from that frame row on, traced through the band's
        Projection)."""
        bad = []
        with torch.inference_mode():
            rmd = cam.ray_directions()
            h, proj = cam.res_h, None
            if c.method in ("bin", "raster"):
                proj = cam.projection()
            if band:
                rmd, h = rmd[band * cam.res_w:], cam.res_h - band
                proj = dataclasses.replace(proj, row0=band)
            hit = trace_rays(scene, cam.pos, rmd, c, acc, h, cam.res_w, proj)
            got = k10.shade_compose(scene, cam.pos, rmd, hit, c)
            ref = shade_compose_reference(scene, cam.pos, rmd, hit, c)
            for f in ("image", "radiance", "normal", "point"):
                same("K10", f, got[f], ref[f], bad)
            torch.cuda.synchronize()
        hits = hit.tri >= 0
        log(f"K10 against its plain version [{case}]: {rmd.shape[0]} rays "
            f"({rmd.dtype}), {len(scene.objects)} objects, hit rate "
            f"{float(hits.float().mean()):.6f}; bitwise {not bad}")
        if bad:
            raise RuntimeError(f"{case}: {bad} differ from the plain version")
        return scene, cam, rmd, hit

    def hold_setup(case, cam, poses, method, row0=0, band_h=None,
                   rays=True):
        """K11 (through `set_up_frame` without autograd) against its plain
        version: the rays, the Projections and the object frames."""
        bad = []
        with torch.inference_mode():
            before = k10.frame_setup.launches
            got = set_up_frame(cam, poses, method, row0, band_h, rays)
            ref = frame_setup_reference(cam, poses, method, row0, band_h,
                                        rays)
            torch.cuda.synchronize()
        if k10.frame_setup.launches == before:
            bad.append("K11 not launched")
        pairs = [("rmd", got.rmd, ref.rmd)]
        projs = [("camera", got.proj, ref.proj)]
        for i, (g, r) in enumerate(zip(got.objects, ref.objects,
                                       strict=True)):
            pairs += [(f"object {i} origin", g.origin, r.origin),
                      (f"object {i} rays", g.rays, r.rays)]
            projs.append((f"object {i}", g.proj, r.proj))
        for name, g, r in projs:
            if (g is None) != (r is None) or (g is not None
                                              and g.row0 != r.row0):
                bad.append(f"K11 {name} Projection")
            elif g is not None:
                pairs += [(f"{name} Projection {f}", getattr(g, f),
                           getattr(r, f))
                          for f in ("origin", "n", "u", "v", "sx", "sy",
                                    "adjust_x", "adjust_y")]
        for name, g, r in pairs:
            if (g is None) != (r is None):
                bad.append(f"K11 {name}")
            elif g is not None:
                same("K11", name, g, r, bad)
        log(f"K11 against its plain version [{case}]: {method}, rows "
            f"[{row0}, {row0 + (band_h or cam.res_h - row0)}) of "
            f"{cam.res_w}x{cam.res_h}, {len(poses)} objects, "
            f"{cam.pos.dtype}, rays {rays}; bitwise {not bad}")
        if bad:
            raise RuntimeError(f"{case}: {bad} differ from the plain version")

    sphere = Scene([SceneObject(Triangles.from_vertices(uv_sphere(50, 50),
                                                        device=dev))])
    scam = cam_at((0.0, 0.0, -3.0), 96, 64)
    sc = dataclasses.replace(cfg, backface_cull=False)
    hold_prepass("sphere 96x64", scam.pos, sphere.objects[0].tris,
                 scam.projection(), sc, 64, 96)
    hold_shade("sphere 96x64", sphere, scam, sc)
    scene, cam = frames[0]
    obj = scene.objects[0]
    o0, proj0 = obj.pose.inv_apply(cam.pos), \
        cam.projection().transformed(obj.pose)
    head = hold_prepass("headline frame 0, live count", o0, obj.tris, proj0,
                        cfg, RES_H, RES_W)
    bucket = 524288
    hold_prepass(f"headline frame 0, bucket {bucket}", o0, obj.tris, proj0,
                 cfg, RES_H, RES_W, bucket)
    band = RES_H // 2
    hold_prepass(f"headline frame 0, the band of rows {band}-{RES_H - 1}",
                 o0, obj.tris, dataclasses.replace(proj0, row0=band), cfg,
                 RES_H - band, RES_W)
    head_shade = hold_shade("headline frame 0", scene, cam, cfg)
    hold_shade(f"headline frame 0, the band of rows {band}-{RES_H - 1}",
               scene, cam, cfg, band=band)
    # animate's scene: two posed objects sharing one Triangles
    tris = obj.tris
    poses = [Pose(from_axis_angle([0.0, 1.0, 0.0], a, device=dev),
                  torch.tensor(t, device=dev))
             for a, t in ((0.35, [-0.55, 0.0, 0.0]),
                          (-0.5, [0.6, 0.1, 0.4]))]
    two = Scene([SceneObject(tris, p) for p in poses])
    tcam = cam_at((0.0, 0.2, -4.0))
    for i, p in enumerate(poses):
        hold_prepass(f"two-object scene, object {i}", p.inv_apply(tcam.pos),
                     tris, tcam.projection().transformed(p), cfg, RES_H,
                     RES_W)
    two_hit = hold_shade("two-object scene", two, tcam, cfg)[3]
    if len(torch.unique(two_hit.obj)) != 3:
        raise RuntimeError("the two-object scene does not show both objects")
    tab64 = kd_tables(dev, headline_tv, dtype=torch.float64)
    scene64 = Scene([SceneObject(Triangles.from_vertices(
        headline_tv, device=dev, dtype=torch.float64))])
    hold_shade("kd frame 0, float64", scene64,
               cam_at((0.0, 0.0, -3.0), dtype=torch.float64),
               RenderConfig(method="kd"), (tab64,))
    del tab64
    pose0 = [obj.pose]
    hold_setup("headline frame 0", cam, pose0, "bin")
    hold_setup("headline frame 0", cam, pose0, "kd")
    hold_setup("headline frame 0, float64", cam_at((0.0, 0.0, -3.0),
                                                   dtype=torch.float64),
               [scene64.objects[0].pose], "kd")
    hold_setup(f"headline frame 0, the band of rows {band}-{RES_H - 1}",
               cam, pose0, "bin", band, RES_H - band)
    hold_setup("headline frame 0, the bin probe", cam, pose0, "bin",
               rays=False)
    hold_setup("two-object scene", tcam, poses, "bin")
    hold_setup("two-object scene", tcam, poses, "raster")
    hold_setup(f"two-object scene, the band of rows {band}-{RES_H - 1}",
               tcam, poses, "fixed", band, RES_H - band)
    del scene64

    # ---- each kernel timed against its plain version and its bound ----
    with torch.inference_mode():
        k8 = {"tri_pass": kernel_ms(lambda: bp.bin_tri_pass(*head["args"]),
                                    "tri_pass_kernel"),
              "ray_table": kernel_ms(lambda: bp.ray_table(*head["rt"]),
                                     "ray_table_kernel")}
        k9 = {"keys": kernel_ms(lambda: bp.bin_entry_keys(*head["kk"]),
                                "entry_keys_kernel"),
              "table": kernel_ms(lambda: bp.bin_entry_table(*head["tt"]),
                                 "entry_table_kernel")}
        hs, hcam, hrmd, hhit = head_shade
        k10_ms = kernel_ms(
            lambda: k10.shade_compose(hs, hcam.pos, hrmd, hhit, cfg),
            "shade_compose_kernel")
        k11_ms = {m: kernel_ms(lambda: set_up_frame(cam, pose0, m),
                               "frame_setup_kernel") for m in ("bin", "kd")}
        rt_args = head["rt"]
        # device time of each twin, captured alone and replayed (the host's
        # pace left out, as from the kernels' profiler times)
        plain = {
            "tri_pass": graph_ms(
                lambda: bp.bin_tri_pass_reference(*head["args"])),
            "ray_table": graph_ms(lambda: _ray_table(
                rt_args[0], rt_args[1], rt_args[2][:3], rt_args[2][3:6],
                *rt_args[3:])),
            "keys": graph_ms(
                lambda: bp.bin_entry_keys_reference(*head["kk"])),
            "table": graph_ms(
                lambda: bp.bin_entry_table_reference(*head["tt"])),
            "shade": graph_ms(lambda: shade_compose_reference(
                hs, hcam.pos, hrmd, hhit, cfg)),
            **{f"setup_{m}": graph_ms(
                lambda m=m: frame_setup_reference(cam, pose0, m))
               for m in ("bin", "kd")}}
        calls = {"tri_pass": graph_ms(lambda: bp.bin_tri_pass(*head["args"])),
                 "shade": graph_ms(lambda: k10.shade_compose(
                     hs, hcam.pos, hrmd, hhit, cfg)),
                 **{f"setup_{m}": graph_ms(
                     lambda m=m: set_up_frame(cam, pose0, m))
                    for m in ("bin", "kd")}}
    t_n, tp = head["args"][2][0].shape[0], head["tp"]
    n_rays, size = head["rays"].shape[0] * head["rays"].shape[1], head["size"]
    e_pad = head["table"][1].shape[0]
    binned = int((tp.ntiles > 0).sum())
    hit_tris = int(torch.unique(hhit.tri[hhit.tri >= 0]).numel())
    n_hit = int((hhit.tri >= 0).sum())
    work = {   # (operations, bytes): each input read once, outputs once
        "tri_pass": (K8_OPS_PER_TRI * t_n, t_n * (36 + 8 + 12 + 44) + 40),
        "ray_table": (RAY_TABLE_OPS_PER_RAY * n_rays, n_rays * 16 + 48),
        "keys": (K9_OPS_PER_TRI * t_n + K9_OPS_PER_ENTRY * size,
                 t_n * 32 + size * 8),
        "table": (K9_OPS_PER_ENTRY * size,
                  size * 16 + binned * 44 + e_pad * 48
                  + (head["n_tiles"] + 1) * 4),
        "shade": (K10_OPS_PER_HIT * n_hit,
                  hrmd.shape[0] * (12 + 4 + 4 + 4 + 3 + 36) + hit_tris * 48),
        # K11 writes the rays, and for kd the object-frame rays too
        "setup_bin": (K11_OPS_PER_RAY * hrmd.shape[0],
                      hrmd.shape[0] * 12 + 4 * (12 + 7 + 16 + 12)),
        "setup_kd": ((K11_OPS_PER_RAY + K11_OPS_PER_OBJECT_RAY)
                     * hrmd.shape[0],
                     hrmd.shape[0] * 24 + 4 * (12 + 7 + 16 + 12))}
    bounds = {k: op_bounds(*v, clock_mhz) for k, v in work.items()}
    for k, b in bounds.items():
        log(f"  {k}: {b['text']}")
    k8_bound = op_bounds(work["tri_pass"][0] + work["ray_table"][0],
                         work["tri_pass"][1] + work["ray_table"][1],
                         clock_mhz)
    k9_bound = op_bounds(work["keys"][0] + work["table"][0],
                         work["keys"][1] + work["table"][1], clock_mhz)
    log(f"K8 at headline frame 0 ({t_n} triangles, {n_rays} rays): "
        f"per-triangle pass {k8['tri_pass']:.4f} ms (its wrapper replayed "
        f"{calls['tri_pass']:.4f}), plain {plain['tri_pass']:.4f}; ray "
        f"table {k8['ray_table']:.4f}, plain {plain['ray_table']:.4f}; "
        f"{k8_bound['text']} ({smi})")
    log(f"K9 at headline frame 0 ({head['live']} entries, {binned} binned "
        f"triangles): keys {k9['keys']:.4f} ms, plain {plain['keys']:.4f}; "
        f"table {k9['table']:.4f}, plain {plain['table']:.4f}; "
        f"{k9_bound['text']} ({smi})")
    log(f"K10 at headline frame 0 ({hrmd.shape[0]} rays, {n_hit} hits on "
        f"{hit_tris} triangles): {k10_ms:.4f} ms (its wrapper replayed "
        f"{calls['shade']:.4f}), plain {plain['shade']:.4f}; "
        f"{bounds['shade']['text']} ({smi})")
    for m in ("bin", "kd"):
        log(f"K11 at headline frame 0, {m} ({hrmd.shape[0]} rays, one "
            f"object): {k11_ms[m]:.4f} ms (its wrapper replayed "
            f"{calls['setup_' + m]:.4f}), plain (replayed) "
            f"{plain['setup_' + m]:.4f}; {bounds['setup_' + m]['text']} "
            f"({smi})")

    # ---- the replayed bin frame's device time by stage, both routes ----
    with torch.inference_mode():
        bkt = hold_prepass("headline frame 0 for the stages", o0, obj.tris,
                           proj0, cfg, RES_H, RES_W, bucket)
        a, rt, kk, tt = bkt["args"], bkt["rt"], bkt["kk"], bkt["tt"]
        geom, entry_tri, starts = bkt["table"]
        rays = bkt["rays"]
        _, _, rmd, hit = head_shade
        radiance, _, _, mask = shade_hits(scene, cam.pos, rmd, hit, cfg)

        def prepass(tri_pass, keys):
            t = tri_pass(*a)
            return keys(torch.cumsum(t.ntiles, 0), t, *kk[2:])
        stages = {
            "kernels": {
                "set-up": lambda: set_up_frame(cam, pose0, "bin"),
                "ray table": lambda: bp.ray_table(*rt),
                "prepass": lambda: prepass(bp.bin_tri_pass,
                                           bp.bin_entry_keys),
                "sort": lambda: torch.sort(bkt["keys"], stable=True),
                "table": lambda: bp.bin_entry_table(*tt),
                "K1": lambda: bin_intersect(rays, geom, entry_tri, starts,
                                            chunk),
                "shading + composition": lambda: k10.shade_compose(
                    scene, cam.pos, rmd, hit, cfg)},
            "plain": {
                "set-up": lambda: frame_setup_reference(cam, pose0, "bin"),
                "ray table": lambda: _ray_table(rt[0], rt[1], rt[2][:3],
                                                rt[2][3:6], *rt[3:]),
                "prepass": lambda: prepass(bp.bin_tri_pass_reference,
                                           bp.bin_entry_keys_reference),
                "sort": lambda: torch.sort(bkt["keys"], stable=True),
                "table": lambda: bp.bin_entry_table_reference(*tt),
                "K1": lambda: bin_intersect(rays, geom, entry_tri, starts,
                                            chunk),
                "shading": lambda: shade_hits(scene, cam.pos, rmd, hit, cfg),
                "composition": lambda: (
                    compose_framebuffer(radiance, mask, cfg.background_rgb),
                    torch.where(mask[..., None], radiance, 0.0))}}
        split = {route: {k: graph_ms(f) for k, f in st.items()}
                 for route, st in stages.items()}
    for route, st in split.items():
        log(f"replayed bin frame by stage, {route} (each stage captured "
            f"alone, frame 0 at bucket {bucket}): "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in st.items())
            + f"; sum {sum(st.values()):.4f} ms ({smi})")

    # ---- the replayed frames and compiled steps, both routes in turns ----
    def plain_set_up(camera, poses, method, row0, band_h, rays):
        """`set_up_frame`'s forward by K11's plain version, also inside
        its autograd Function."""
        with torch.no_grad():
            return frame_setup_reference(camera, poses, method, row0,
                                         band_h, rays)

    @contextlib.contextmanager
    def route(kind):
        """The plain versions in the kernels' places (``kind`` "plain"), as
        phase 3 puts the aligned walk in K1's place; the steps' shading
        then runs K10's and K12's twins, their set-up K11's plain version
        and K13's twin."""
        names = ((k10, "shade_compose", shade_compose_reference),
                 (k10, "shade_grad", shade_grad_reference),
                 (k10, "frame_setup_grad", frame_setup_grad_reference),
                 (binning, "bin_tri_pass", bp.bin_tri_pass_reference),
                 (binning, "bin_entry_keys", bp.bin_entry_keys_reference),
                 (binning, "bin_entry_table", bp.bin_entry_table_reference),
                 (traverse, "ray_table",
                  lambda proj, o, b, *rest: _ray_table(proj, o, b[:3],
                                                       b[3:6], *rest)),
                 (renderer, "shade_compose", shade_compose_reference),
                 (camera_mod, "_set_up", plain_set_up))
        saved = [getattr(m, n) for m, n, _ in names]
        if kind == "plain":
            for m, n, f in names:
                setattr(m, n, f)
        try:
            yield
        finally:
            for (m, n, _), f in zip(names, saved):
                setattr(m, n, f)

    kinds = ("kernels", "plain")
    frames_by = {}
    kd_tab = kd_tables(dev, headline_tv)
    for method, c, acc in (("bin", cfg, None),
                           ("pallas2", ccfgs["pallas2"], (accel,)),
                           ("pallas", ccfgs["pallas"], (accel,)),
                           ("kd", RenderConfig(method="kd"), (kd_tab,))):
        caches = {k: GraphCache() for k in kinds}
        saved_cache = renderer.FRAME_GRAPHS
        k11 = {k: 0 for k in kinds}

        def run(kind, i):
            renderer.FRAME_GRAPHS = caches[kind]
            before = k10.frame_setup.launches
            with route(kind):
                out = render_jit(*frames[i % N_FRAMES], c, acc)
            k11[kind] += k10.frame_setup.launches - before
            return out
        try:
            bad = [f"frame {i} {f}" for i in (0, 1)
                   for f in differ(run("kernels", i), run("plain", i))]
            ms = in_turns(run, kinds, N_PAIRED)
            prof = {k: replay_profile(lambda: run(k, 0)) for k in kinds}
            top = device_profile(lambda: run("kernels", 0))[2]
        finally:
            renderer.FRAME_GRAPHS = saved_cache
        frames_by[method] = prof["kernels"][3]
        log(f"replayed {method} frames, kernels and plain route in turns: "
            f"bitwise {not bad}; "
            + "; ".join(f"{k} {spread(v)}, profiled: device busy "
                        f"{prof[k][0]:.3f} ms in {prof[k][1]} device "
                        f"operations, {prof[k][2]} host operations"
                        for k, v in ms.items())
            + f"; kernels seen {prof['kernels'][3]}; K11 launches (captures "
            f"and probes) {k11}; the largest device kernels of a replay with "
            f"the kernels (name, count, ms): {top} ({smi})")
        seen = prof["kernels"][3]
        if bad or not seen["shade_compose"] or k11["kernels"] < 1 \
                or k11["plain"] or prof["plain"][3]["frame_setup"] or (
                    method == "bin") != (seen["bin_tri_pass"] > 0
                                         and seen["bin_entry_table"] > 0):
            raise RuntimeError(f"replayed {method} frames: {bad}, {seen}, "
                               f"K11 {k11}, plain route {prof['plain'][3]}")
    del kd_tab

    steps_by = {}
    for kind in ("all-leaves", "pose/light/camera-only"):
        sets = {k: train_set(dev, headline_tv) for k in kinds}
        if kind != "all-leaves":
            for p in sets.values():
                p["scene"].objects[0].tris.requires_grad_(False)
                p["camera"].requires_grad_(False)
                p["camera"].pos.requires_grad_(True)

        def leaves(p):
            return [*p["scene"].parameters(), *p["camera"].parameters()]
        opts = {k: torch.optim.SGD(
            [x for x in leaves(p) if x.requires_grad], lr=LR)
            for k, p in sets.items()}
        steps = {k: make_train_step_jit(opts[k], cfg) for k in kinds}

        def run_step(k, _i=0):
            with route(k):
                return steps[k](sets[k], target)
        losses = {k: [float(run_step(k)) for _ in range(N_JIT_STEPS)]
                  for k in kinds}
        ms = in_turns(run_step, kinds, N_PAIRED // 2)
        prof = {k: replay_profile(lambda: run_step(k)) for k in kinds}
        equal = all(torch.equal(a, b) for a, b in
                    zip(leaves(sets["kernels"]), leaves(sets["plain"])))
        steps_by[kind] = prof["kernels"][3]
        log(f"compiled {kind} steps, kernels and plain route in turns: "
            f"losses {losses['kernels']} / {losses['plain']}, parameters "
            f"bitwise equal {equal}; "
            + "; ".join(f"{k} {spread(v)}, profiled: device busy "
                        f"{prof[k][0]:.3f} ms in {prof[k][1]} device "
                        f"operations, {prof[k][2]} host operations"
                        for k, v in ms.items())
            + f"; kernels seen {prof['kernels'][3]} ({smi})")
        seen, plain_seen = prof["kernels"][3], prof["plain"][3]
        if not equal or losses["kernels"] != losses["plain"] \
                or not seen["shade_compose"] or not seen["shade_grad"] \
                or not seen["frame_setup"] or not seen["frame_setup_grad"] \
                or not seen["bin_tri_pass"] or any(plain_seen[k] for k in (
                    "shade_compose", "shade_grad", "frame_setup",
                    "frame_setup_grad")):
            raise RuntimeError(f"compiled {kind} steps: {seen}, plain "
                               f"route {plain_seen}")
        del sets, opts, steps

    # ---- launches on the eager main paths, the counters from 0 ----
    for f in wrappers.values():
        f.launches = 0
    for f in frames:
        render(*f, cfg)
    serve = {k: f.launches for k, f in wrappers.items()}
    for method, c, acc in (("pallas2", ccfgs["pallas2"], (accel,)),
                           ("pallas", ccfgs["pallas"], (accel,))):
        k10.shade_compose.launches = 0
        k10.frame_setup.launches = 0
        render(*frames[0], c, acc)
        serve[f"shade_compose_{method}"] = k10.shade_compose.launches
        serve[f"frame_setup_{method}"] = k10.frame_setup.launches
    for f in (*wrappers.values(), k10.shade_grad, k10.frame_setup_grad):
        f.launches = 0
    p = train_set(dev, headline_tv)
    make_train_step(torch.optim.SGD([*p["scene"].parameters(),
                                     *p["camera"].parameters()], lr=LR),
                    cfg)(p, target)
    train = {k: f.launches for k, f in wrappers.items()}
    train_k12 = k10.shade_grad.launches
    train_k13 = k10.frame_setup_grad.launches
    log(f"launches: {N_FRAMES} bin frames through render {serve}; one "
        f"bin training step {train}, K12 {train_k12}, K13 {train_k13}")
    if min(serve.values()) < 1 or min(serve[k] for k in wrappers) < N_FRAMES \
            or train["shade_compose"] != 1 or train_k12 != 1 \
            or train["frame_setup"] != 1 or train_k13 != 1 or min(
                train[k] for k in SERVING_KERNELS[:4]) < 1:
        raise RuntimeError("the serving kernels missed their paths")

    def by_path(keys):
        out = {"serve": sum(serve[k] for k in keys),
               "train": sum(train[k] for k in keys)}
        for m, seen in frames_by.items():
            out["serve_jit" if m == "bin" else f"serve_jit_{m}"] = sum(
                seen[k] for k in keys)
        out["train_jit"] = sum(steps_by["all-leaves"][k] for k in keys)
        out["train_jit_pose_light_camera"] = sum(
            steps_by["pose/light/camera-only"][k] for k in keys)
        return out
    k10_paths = by_path(["shade_compose"])
    k11_paths = by_path(["frame_setup"])
    for m in ("pallas2", "pallas"):
        k10_paths[f"serve_{m}"] = serve[f"shade_compose_{m}"]
        k11_paths[f"serve_{m}"] = serve[f"frame_setup_{m}"]
    base = "cpp_cuda_raytracer_dev_tpu/"
    return (train_k12, train_k13), [{
        "name": "bin_tri_pass", "route": "cuda",
        "source": "cpp_cuda_raytracer_dev_torch/csrc/bin_prepass.cu",
        "replaces": base + "accel/binning.py:67",
        "replaces_note": "with accel/traverse.py:532 (root box, _ray_table); "
                         "XLA-fused plain ops, not a Pallas kernel",
        "launches": serve["bin_tri_pass"], "max_abs_err": max_err["K8"],
        "ms": k8["tri_pass"] + k8["ray_table"],
        "plain_ms": plain["tri_pass"] + plain["ray_table"],
        "bound_ms": k8_bound["bound_ms"], "bound_by": k8_bound["bound_by"],
        "library_ms": None, "launch_ms": k8,
        "launch_plain_ms": {k: plain[k] for k in k8},
        "launch_bound_ms": {k: bounds[k]["bound_ms"] for k in k8},
        "stages_ms": split, "ray_table_launches": serve["ray_table"],
        "launches_by_path": by_path(["bin_tri_pass"])}, {
        "name": "bin_entry_keys", "route": "cuda",
        "source": "cpp_cuda_raytracer_dev_torch/csrc/bin_prepass.cu",
        "replaces": base + "accel/binning.py:67",
        "replaces_note": "the entry passes around lax.sort; XLA-fused plain "
                         "ops, not a Pallas kernel",
        "launches": serve["bin_entry_keys"], "max_abs_err": max_err["K9"],
        "ms": k9["keys"] + k9["table"],
        "plain_ms": plain["keys"] + plain["table"],
        "bound_ms": k9_bound["bound_ms"], "bound_by": k9_bound["bound_by"],
        "library_ms": None, "launch_ms": k9,
        "launch_plain_ms": {k: plain[k] for k in k9},
        "launch_bound_ms": {k: bounds[k]["bound_ms"] for k in k9},
        "table_launches": serve["bin_entry_table"],
        "launches_by_path": by_path(["bin_entry_keys"])}, {
        "name": "shade_compose", "route": "cuda",
        "source": "cpp_cuda_raytracer_dev_torch/csrc/shade.cu",
        "replaces": base + "models/renderer.py:116",
        "replaces_note": "with ops/shade.py:46,76,86; XLA-fused plain ops, "
                         "not a Pallas kernel",
        "launches": serve["shade_compose"], "max_abs_err": max_err["K10"],
        "ms": k10_ms, "plain_ms": plain["shade"],
        "bound_ms": bounds["shade"]["bound_ms"],
        "bound_by": bounds["shade"]["bound_by"], "library_ms": None,
        "call_ms": calls["shade"], "launches_by_path": k10_paths}, {
        "name": "frame_setup", "route": "cuda",
        "source": "cpp_cuda_raytracer_dev_torch/csrc/shade.cu",
        "replaces": base + "models/camera.py:124",
        "replaces_note": "with models/camera.py:107 (projection) and the pose "
                         "transforms of models/renderer.py trace_rays; "
                         "XLA-fused plain ops, not a Pallas kernel",
        "launches": serve["frame_setup"], "max_abs_err": max_err["K11"],
        "ms": k11_ms["bin"], "plain_ms": plain["setup_bin"],
        "bound_ms": bounds["setup_bin"]["bound_ms"],
        "bound_by": bounds["setup_bin"]["bound_by"], "library_ms": None,
        "call_ms": calls["setup_bin"], "kd_ms": k11_ms["kd"],
        "kd_plain_ms": plain["setup_kd"],
        "kd_bound_ms": bounds["setup_kd"]["bound_ms"],
        "launches_by_path": k11_paths}]


def run_shade_grad(dev, headline_tv, cfg, target, smi, clock_mhz,
                   train_k12_k13):
    """Phase 18 (see the module docstring): kernels K12, the training
    shading's backward, and K13, the training set-up's. Returns their rows
    of the kernels line, whose ``launches`` are ``train_k12_k13``, phase
    17's counts in one eager bin training step."""
    import contextlib

    from cpp_cuda_raytracer_dev_torch.models import shade_grad as sg
    from cpp_cuda_raytracer_dev_torch.models.renderer import trace_rays
    from cpp_cuda_raytracer_dev_torch.ops.cuda import shade as k10
    from cpp_cuda_raytracer_dev_torch.parallel.render_pjit import \
        make_train_step_jit

    p = train_set(dev, headline_tv)
    scene, cam = p["scene"], p["camera"]
    with torch.no_grad():
        rmd = cam.ray_directions()
        hit = trace_rays(scene, cam.pos, rmd, cfg, None, RES_H, RES_W,
                         cam.projection())
        rad = k10.shade_compose(scene, cam.pos, rmd, hit, cfg)["radiance"]
        # the steps' cotangent: d mean((radiance - target)^2) / d radiance
        ct = 2.0 * (rad - target.reshape(-1, 3)) / rad.numel()
    gen = torch.Generator(device=dev).manual_seed(18)
    ct_n, ct_p = (torch.randn(rmd.shape, generator=gen, device=dev)
                  for _ in range(2))
    # (cotangents, rows, the rays' cotangent, the tables', hit t's)
    cases = {"pose/light/camera step": ((ct, None, None), True, True, False,
                                        False),
             "all-leaves step": ((ct, None, None), True, True, True, False),
             "every cotangent and output": ((ct, ct_n, ct_p), True, True,
                                            True, True)}
    args = {k: (scene, cam.pos, rmd, hit, cfg, *v) for k, v in cases.items()}
    bad, err = [], 0.0
    for name, a in args.items():
        with torch.no_grad():
            got, want = k10.shade_grad(*a), sg.shade_grad_reference(*a)
        torch.cuda.synchronize()
        for part, x, y in zip(("partials", "consts", "rays", "rows",
                               "hit_t"), got, want):
            if x is None and y is None:
                continue
            err = max(err, float((x.double() - y.double()).abs().max()))
            if not torch.equal(x, y):
                bad.append(f"{name}: {part}")
    log(f"K12 against its plain twin at headline frame 0 ({rmd.shape[0]} "
        f"rays, {int((hit.tri >= 0).sum())} hits; {', '.join(cases)}): "
        f"bitwise {not bad} {bad}")
    if bad:
        raise RuntimeError(f"K12 differs from its twin: {bad}")

    # K12 timed against its twin and its bound, for each step's call
    ms = {k: kernel_ms(lambda k=k: k10.shade_grad(*args[k]),
                       "shade_grad_kernel") for k in list(cases)[:2]}
    plain = {k: graph_ms(lambda k=k: sg.shade_grad_reference(*args[k]))
             for k in list(cases)[:2]}
    n_r, n_hit = rmd.shape[0], int((hit.tri >= 0).sum())
    hit_tris = int(torch.unique(hit.tri[hit.tri >= 0]).numel())
    # each input read once (the rays, t, ids and the cotangent a ray, the
    # hit triangles' 12 leaves), each output written once (24 partials,
    # the rays' cotangent, and the tables' 12-wide rows)
    base = n_r * (12 + 12 + 12 + 96 + 12) + hit_tris * 48
    work = {"pose/light/camera step": (K12_OPS_PER_HIT * n_hit, base),
            "all-leaves step": (K12_OPS_PER_HIT * n_hit, base + n_r * 48)}
    bounds = {k: op_bounds(*v, clock_mhz) for k, v in work.items()}
    for k in ms:
        log(f"K12 at headline frame 0, the {k}'s call: {ms[k]:.4f} ms, its "
            f"twin captured alone {plain[k]:.4f} ms; {bounds[k]['text']} "
            f"({smi})")

    # a compiled step, the kernel route against the twin route, in turns
    @contextlib.contextmanager
    def route(kind):
        saved = k10.shade_grad
        if kind == "twin":
            k10.shade_grad = sg.shade_grad_reference
        try:
            yield
        finally:
            k10.shade_grad = saved
    kinds = ("kernel", "twin")
    train_k12, train_k13 = train_k12_k13
    step_ms, launches_by_path = {}, {"train": train_k12}
    k13_paths = {"train": train_k13}
    for kind in ("pose/light/camera-only", "all-leaves"):
        sets = {k: train_set(dev, headline_tv) for k in kinds}
        if kind != "all-leaves":
            for q in sets.values():
                q["scene"].objects[0].tris.requires_grad_(False)

        def leaves(q):
            return [x for x in (*q["scene"].parameters(),
                                *q["camera"].parameters()) if x.requires_grad]
        steps = {k: make_train_step_jit(torch.optim.SGD(leaves(q), lr=LR),
                                        cfg) for k, q in sets.items()}

        def run(k, _i=0):
            with route(k):
                return steps[k](sets[k], target)
        counts = (k10.shade_compose.launches, k10.shade_grad.launches)
        losses = {k: [float(run(k)) for _ in range(N_JIT_STEPS)]
                  for k in kinds}
        turns = in_turns(run, kinds, N_PAIRED)
        prof = {k: replay_profile(lambda k=k: run(k)) for k in kinds}
        equal = all(torch.equal(a, b) for a, b in
                    zip(leaves(sets["kernel"]), leaves(sets["twin"])))
        moved = (k10.shade_compose.launches - counts[0],
                 k10.shade_grad.launches - counts[1])
        step_ms[kind] = {k: float(np.median(v)) for k, v in turns.items()}
        seen = prof["kernel"][3]
        path = ("train_jit" if kind == "all-leaves" else
                "train_jit_pose_light_camera")
        launches_by_path[path] = seen["shade_grad"]
        k13_paths[path] = seen["frame_setup_grad"]
        log(f"compiled {kind} steps, K12 and its twin in turns: losses "
            f"{losses['kernel']} / {losses['twin']}, parameters bitwise "
            f"equal {equal}; "
            + "; ".join(f"{k} {spread(v)}, profiled: device busy "
                        f"{prof[k][0]:.3f} ms in {prof[k][1]} device "
                        f"operations, {prof[k][2]} host operations"
                        for k, v in turns.items())
            + f"; kernels seen {seen}; counters moved (K10 launches, K12 "
            f"launches) {moved} ({smi})")
        if not equal or losses["kernel"] != losses["twin"] \
                or seen["shade_grad"] < 1 or seen["shade_compose"] < 1 \
                or prof["twin"][3]["shade_grad"] or moved[1] < 1:
            raise RuntimeError(f"compiled {kind} steps: {seen}, {moved}")
        del sets, steps
    log(f"counters: shade_compose.launches {k10.shade_compose.launches}, "
        f"shade_grad.launches {k10.shade_grad.launches}, "
        f"frame_setup.launches {k10.frame_setup.launches}, "
        f"frame_setup_grad.launches {k10.frame_setup_grad.launches}")
    k13 = run_setup_grad(cam, args["pose/light/camera step"], smi, clock_mhz)
    k13.update(launches=train_k13, launches_by_path=k13_paths)
    k = "pose/light/camera step"
    return [{
        "name": "shade_grad", "route": "cuda",
        "source": "cpp_cuda_raytracer_dev_torch/csrc/shade.cu",
        "replaces": None,
        "replaces_note": "none: JAX differentiates models/renderer.py:116 "
                         "shade_hits by itself; K12 is the backward of the "
                         "autograd Function whose forward is K10",
        "launches": train_k12, "max_abs_err": err,
        "ms": ms[k], "plain_ms": plain[k], "bound_ms": bounds[k]["bound_ms"],
        "bound_by": bounds[k]["bound_by"], "library_ms": None,
        "bound_issue_ms": bounds[k]["bound_issue_ms"],
        "all_leaves_ms": ms["all-leaves step"],
        "all_leaves_plain_ms": plain["all-leaves step"],
        "all_leaves_bound_ms": bounds["all-leaves step"]["bound_ms"],
        "step_ms": step_ms, "launches_by_path": launches_by_path}, k13]


def run_setup_grad(cam, shade_args, smi, clock_mhz) -> dict:
    """Phase 18's K13 (see the module docstring): bitwise its twin on the
    rays' cotangent that K12 writes for ``shade_args`` (the pose/light/
    camera step's call), timed. Returns its row of the kernels line,
    without the launches."""
    from cpp_cuda_raytracer_dev_torch import Camera
    from cpp_cuda_raytracer_dev_torch.models.camera import _adjust
    from cpp_cuda_raytracer_dev_torch.models.setup_grad import \
        frame_setup_grad_reference
    from cpp_cuda_raytracer_dev_torch.ops.cuda import shade as k13

    with torch.no_grad():
        g_rmd = k13.shade_grad(*shade_args)[2]
        leaves = [getattr(cam, f).detach() for f in Camera.LEAVES]
        w, h = cam.res_w, cam.res_h
        band = RES_H // 2
        cases = {"float32": (leaves, g_rmd, 0),
                 "float64": ([x.double() for x in leaves], g_rmd.double(), 0),
                 f"band of rows {band}-{h - 1}": (leaves, g_rmd[band * w:],
                                                  band)}
        args = {k: (lv, g, w, h, row0, _adjust(w), _adjust(h), [True] * 6)
                for k, (lv, g, row0) in cases.items()}
        bad, err = [], 0.0
        for name, a in args.items():
            got = k13.frame_setup_grad(*a)
            torch.cuda.synchronize()
            want = frame_setup_grad_reference(*a)
            for f, x, y in zip(Camera.LEAVES, got, want):
                err = max(err, float((x.double() - y.double()).abs().max()))
                if not torch.equal(x, y):
                    bad.append(f"{name}: {f}")
    log(f"K13 against its plain twin at headline frame 0 with K12's rays' "
        f"cotangent ({g_rmd.shape[0]} rays; {', '.join(cases)}): bitwise "
        f"{not bad} {bad}, largest difference {err}")
    if bad:
        raise RuntimeError(f"K13 differs from its twin: {bad}")

    a = args["float32"]
    ms = {k: kernel_ms(lambda: k13.frame_setup_grad(*a), k)
          for k in ("frame_setup_grad_kernel", "frame_setup_grad_chain")}
    call_ms = graph_ms(lambda: k13.frame_setup_grad(*a))
    plain_ms = graph_ms(lambda: frame_setup_grad_reference(*a))
    n_r = g_rmd.shape[0]
    # the rays' cotangent read once, nine partials a ray written once
    bound = op_bounds(K13_OPS_PER_RAY * n_r, n_r * 4 * (3 + 9), clock_mhz)
    ray_ms = ms["frame_setup_grad_kernel"]
    log(f"K13 at headline frame 0: the ray pass {ray_ms:.4f} ms, the chain "
        f"{ms['frame_setup_grad_chain']:.4f} ms; the "
        f"call (both launches and the sum) captured alone {call_ms:.4f} ms, "
        f"its twin {plain_ms:.4f} ms; the ray pass's {bound['text']} ({smi})")
    return {
        "name": "frame_setup_grad", "route": "cuda",
        "source": "cpp_cuda_raytracer_dev_torch/csrc/shade.cu",
        "replaces": None,
        "replaces_note": "none: JAX differentiates models/camera.py:124 "
                         "ray_directions by itself; K13 is the backward of "
                         "the autograd Function whose forward is K11",
        "max_abs_err": err, "ms": ms["frame_setup_grad_kernel"],
        "chain_ms": ms["frame_setup_grad_chain"], "call_ms": call_ms,
        "plain_ms": plain_ms, "bound_ms": bound["bound_ms"],
        "bound_by": bound["bound_by"], "library_ms": None,
        "bound_issue_ms": bound["bound_issue_ms"]}


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
    written to a PLY file. Returns ({method: {kernel: launches in
    ``render_cli``}}, {kernel: instances in the profiled ``animate`` run})
    for K1, K2, K4-K7 and `SERVING_KERNELS`."""
    import contextlib
    from pathlib import Path

    from cpp_cuda_raytracer_dev_torch import (Camera, RenderConfig, Scene,
                                              SceneObject, Triangles)
    from cpp_cuda_raytracer_dev_torch.apps import animate, render_cli
    from cpp_cuda_raytracer_dev_torch.models.renderer import trace_rays
    from cpp_cuda_raytracer_dev_torch.ops.cuda import bin_intersect as k1
    from cpp_cuda_raytracer_dev_torch.ops.cuda import bin_prepass as bp
    from cpp_cuda_raytracer_dev_torch.ops.cuda import bin_tile_intersect as bt
    from cpp_cuda_raytracer_dev_torch.ops.cuda import kd_traverse as k7
    from cpp_cuda_raytracer_dev_torch.ops.cuda import segment_sum as k2
    from cpp_cuda_raytracer_dev_torch.ops.cuda import shade as k10
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
                "K6": bt.bin_tile_intersect, "K7": k7.kd_traverse,
                **{k: getattr(bp, k) for k in SERVING_KERNELS[:4]},
                "shade_compose": k10.shade_compose,
                "frame_setup": k10.frame_setup}

    # the apps' camera (render_cli.py): framed on the mesh's bounding box
    v = headline_tv.reshape(-1, 3)
    lo, hi = v.min(0), v.max(0)
    center, size = (lo + hi) / 2, float(np.linalg.norm(hi - lo))
    scene = Scene([SceneObject(Triangles.from_vertices(headline_tv,
                                                       device=dev))])
    oracle_cfg = RenderConfig(method="fixed", chunk=16384,
                              draw_distance=max(400.0, 10 * size))
    kernel_of = {"bin": "K1", "pallas2": "K4", "kd": "K7"}
    cli_launches = {}
    w, h = RES_W, RES_H
    for method in kernel_of:
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
        want = [kernel_of[method], "shade_compose", "frame_setup"]
        if method == "bin":
            want += ["bin_tri_pass", "bin_entry_keys"]
        cli_launches[method] = launched
        if agree < MIN_AGREE:
            raise RuntimeError(f"render_cli {method}: PNG and oracle agree on "
                               f"{agree}")
        if min(launched[k] for k in want) < 1:
            raise RuntimeError(f"render_cli {method} did not launch {want}")

    # animate: the key script on two objects sharing one Triangles
    report = out_dir / "animate.json"
    hud = out_dir / "animate_hud.txt"
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()

    def run_animate():
        with open(hud, "w") as f, contextlib.redirect_stdout(f):
            animate.main(["--mesh", str(mesh), "--res", str(RES_W),
                          str(RES_H), "--frames", str(N_ANIMATE_TICKS),
                          "--second-object", "--method", "bin",
                          "--json-out", str(report)])
    # its frames are replays of one captured graph (render_jit): the
    # counter sees the capture, the profiler every K1 in the replays
    animate_seen = replay_profile(run_animate)[3]
    seen = animate_seen["bin_intersect"]
    secs = time.perf_counter() - t0
    k1_launches = k1.bin_intersect.launches
    rep = json.loads(report.read_text())
    log(f"animate --second-object --method bin at {RES_W}x{RES_H}: "
        f"{rep['frames']} ticks in {secs:.2f} s in all (profiled), objects "
        f"{rep['objects']}, device ms a frame {rep['device_ms_per_frame']!r} "
        f"(animate's device_time), bin_intersect launches {k1_launches} "
        f"(warm-ups and captures), kernel instances on the device "
        f"{animate_seen}; HUD in {hud.name} ({smi})")
    if (rep["frames"] != N_ANIMATE_TICKS or rep["objects"] != 2
            or k1_launches < 2 or seen < 2 * N_ANIMATE_TICKS
            or animate_seen["bin_tri_pass"] < 2 * N_ANIMATE_TICKS
            or animate_seen["shade_compose"] < N_ANIMATE_TICKS
            or animate_seen["frame_setup"] < N_ANIMATE_TICKS):
        raise RuntimeError("animate did not render its ticks through K1 "
                           "and K8 twice a frame and K10 and K11 once")
    return cli_launches, animate_seen


if __name__ == "__main__":
    main()
