"""A ``train`` mix: a closed loop of the program's compiled training
step, `make_train_step_jit`, with SGD, fitting the mix's groups of leaves
(``train``) to a target image.

The generator makes the true leaves: the initial ones with seeded normal
noise of the scale ``noise`` gives each leaf (a quaternion is
renormalised). Set-up renders the target from them with the reference
renderer (its time is left out of ``setup_s``), builds the one step
object the window runs, and drives it through its first three steps:
their losses, the first step's gradients as SGD reads them (``.grad``
after the step) and the parameters' change over the three are what the
check compares with the reference's three steps from the same initial
leaves. The window's milliseconds a step are the window's time over the
steps completed in it, on the host's clock, after a synchronise."""

from __future__ import annotations

import time

import torch

from benchmark.harness import check, scene as scene_mod, trace as trace_mod
from benchmark.harness.runtime import Run
from benchmark.reference import render as reference

CHECK_STEPS = 3


def trained(mix: dict, names) -> list[str]:
    """The leaf names, among ``names``, of the groups the mix trains."""
    return [k for k in names if k.split(".")[0] in mix["train"]]


@torch.no_grad()
def truth(mix: dict, seed: int, lv: dict) -> dict:
    """The true leaves: ``lv`` with seeded noise (a generator on the
    leaves' device), scaled per leaf by ``mix["noise"]`` (a group name
    such as "tris" or "tris.color" sets the leaves under it; the longer
    name wins)."""
    dev = next(iter(lv.values())).device
    g = torch.Generator(device=dev)
    g.manual_seed(seed % (1 << 63))
    out = {}
    for k, x in lv.items():
        scale = 0.0
        for prefix, s in sorted(mix["noise"].items(), key=lambda i: len(i[0])):
            if k == prefix or k.startswith(prefix + "."):
                scale = s
        noise = torch.randn(x.shape, generator=g, device=dev)
        y = x + scale * noise if scale else x.clone()
        if k == "pose.quat":
            y = y * torch.rsqrt((y * y).sum())
        out[k] = y
    return out


def target_image(run: Run, lv: dict) -> torch.Tensor:
    """The reference's radiance (H, W, 3) of the true leaves."""
    cfg, mix = run.cell.config, run.cell.traffic
    true = truth(mix, run.seed, lv)
    tris, pose, camera, phong = scene_mod.reference_inputs(cfg, true)
    out = reference.render(tris, pose, camera, phong, scene_mod.cull(cfg))
    cam = cfg["camera"]
    return out["radiance"].reshape(cam["res_h"], cam["res_w"], 3)


def reference_steps(run: Run, lv0: dict, target: torch.Tensor,
                    precision: str = "float32", keep=None) -> dict:
    """The reference's `CHECK_STEPS` SGD steps from the leaves ``lv0``:
    its losses, first gradients and change of the trained leaves.
    ``precision`` "tf32" rounds the leaves by `reference.tf32` first (the
    control); ``keep``, a (R,) mask, leaves the other pixels out of the
    loss's mean (a fault)."""
    cfg, mix = run.cell.config, run.cell.traffic
    names = trained(mix, lv0)
    lr = mix["lr"]
    lv = {k: v.detach().clone() for k, v in lv0.items()}
    if precision == "tf32":
        lv = {k: reference.tf32(v) for k, v in lv.items()}
    start = {k: lv[k].clone() for k in names}
    flat_target = target.reshape(-1, 3)
    losses, grad = [], {}
    for s in range(CHECK_STEPS):
        for k in names:
            lv[k].requires_grad_(True)
        tris, pose, camera, phong = scene_mod.reference_inputs(cfg, lv)
        loss = reference.loss(tris, pose, camera, phong,
                              scene_mod.cull(cfg), flat_target, keep)
        gs = torch.autograd.grad(loss, [lv[k] for k in names],
                                 allow_unused=True)
        losses.append(loss.item())
        with torch.no_grad():
            new = {}
            for k, g in zip(names, gs):
                g = torch.zeros_like(lv[k]) if g is None else g
                if s == 0:
                    grad[k] = g.clone()
                new[k] = lv[k].detach() - lr * g
            lv.update(new)
    change = {k: lv[k].detach() - start[k] for k in names}
    return {"losses": losses, "grad": grad, "change": change}


def run(run: Run) -> dict:
    cell, dev = run.cell, run.device
    cfg, mix = cell.config, cell.traffic
    tv = scene_mod.vertices(cfg)
    lv = scene_mod.leaves(cfg, tv, dev)
    run.sync()
    t_ref = time.perf_counter()
    target = target_image(run, lv)
    run.sync()
    ref_s = time.perf_counter() - t_ref
    prog = scene_mod.build_program(cfg, lv, tv)
    from cpp_cuda_raytracer_dev_torch.parallel.render_pjit import (
        make_train_step_jit)
    params = {"scene": prog.scene, "camera": prog.camera}
    named = scene_mod.program_leaves(prog)
    names = trained(mix, named)
    for k, p in named.items():
        p.requires_grad_(k in names)
    opt = torch.optim.SGD([named[k] for k in names], lr=mix["lr"])
    step = make_train_step_jit(opt, prog.render_config, None, prog.accel)

    # the first steps, through the window's own call, checked afterwards
    p0 = {k: named[k].detach().clone() for k in names}
    losses = [step(params, target)]
    grad = {k: named[k].grad.detach().clone() for k in names}
    losses += [step(params, target) for _ in range(CHECK_STEPS - 1)]
    change = {k: named[k].detach() - p0[k] for k in names}
    for _ in range(mix["warmup_steps"]):
        step(params, target)
    cache = step.graphs()
    captures = cache.captures

    t_start = run.window_start(excluded_s=ref_s)
    n, last = 0, losses[-1]
    traced = None
    if run.trace:
        traced = trace_mod.profile(
            lambda _k: step(params, target), mix["trace_steps"], "train",
            {"rays": cfg["camera"]["res_w"] * cfg["camera"]["res_h"],
             "triangles": tv.shape[0]}, run.device_kind(), run.sync)
        n += mix["trace_steps"]
    while time.perf_counter() - t_start < run.seconds:
        last = step(params, target)
        n += 1
    run.sync()
    window_s = time.perf_counter() - t_start
    in_window = step.graphs().captures - captures + (
        step.graphs() is not cache)
    run.log(f"steps {n} in {window_s:.4f} s; last loss {float(last):.6g}; "
            f"graphs captured in the window {in_window}, regrowths "
            f"{step.graphs().regrown}, buckets "
            f"{list(step.graphs().buckets.values())}")
    if in_window:
        raise RuntimeError(f"{in_window} graphs were captured inside the "
                           "window")
    memory = run.memory_peak()
    prog_side = {"losses": [float(x) for x in losses], "grad": grad,
                 "change": change}
    del step, opt, params, prog, named
    ref = reference_steps(run, scene_mod.leaves(cfg, tv, dev), target)
    numbers = check.train_numbers(prog_side, ref)
    run.log(f"losses: program {prog_side['losses']}, reference "
            f"{ref['losses']}")
    for part, keys in (("grad", sorted(ref["grad"])),
                       ("change", check.moved_leaves(ref))):
        gap, leaf = check.worst_leaf(prog_side[part], ref[part], keys)
        run.log(f"{part}: worst leaf {leaf} ({gap:.3e}); norms program / "
                "reference " + ", ".join(
                    f"{k} {float(prog_side[part][k].norm()):.6e} / "
                    f"{float(ref[part][k].norm()):.6e}" for k in keys))
    return {"numbers": numbers, "attempted": n, "failed": 0,
            "end_to_end": {"train_step_ms": window_s * 1e3 / n},
            "memory": memory, "trace": traced,
            "note": f"the target's render, left out of setup_s: "
                    f"{ref_s:.3f} s"}


def control(run: Run) -> dict:
    """The control's and the half-batch fault's numbers of the first
    three steps: the reference in TF32 (`reference.tf32`) put in the
    program's place, and the reference with the loss's mean over half the
    pixels, each against the reference."""
    cfg = run.cell.config
    tv = scene_mod.vertices(cfg)
    lv = scene_mod.leaves(cfg, tv, run.device)
    target = target_image(run, lv)
    ref = reference_steps(run, lv, target)
    low = reference_steps(run, lv, target, precision="tf32")
    rays = cfg["camera"]["res_w"] * cfg["camera"]["res_h"]
    g = torch.Generator(device="cpu")
    g.manual_seed(run.seed % (1 << 63))
    keep = (torch.randperm(rays, generator=g) < rays // 2).to(run.device)
    half = reference_steps(run, lv, target, keep=keep)
    return {"control": check.train_numbers(low, ref),
            "half_batch": check.train_numbers(half, ref)}
