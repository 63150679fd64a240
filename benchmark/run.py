#!/usr/bin/env python3
"""Run one cell of the benchmark of the PyTorch/CUDA port once.

    python3 benchmark/run.py --workload bin.orbit --seed 7 --seconds 10 \
        --trace 0

The cell (an entry of ``BENCHMARK.json`` ``workloads``) names its
configuration (``benchmark/configs/<config>.json``) and its traffic mix
(``benchmark/traffic/<mix>.json``), whose ``kind`` names the module that
runs it (``benchmark/kinds/<kind>.py``); the cell's limits are in
``benchmark/limits/<cell>.json`` and each per-layer metric is read by
``benchmark/metrics/<metric>.py``. The run builds its inputs from
``--seed``, warms up, measures for ``--seconds`` and checks the frames or
steps against the plain reference (``benchmark/reference/``). With
``--trace 0`` the result's metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a profiled stretch at the
window's start. The last line of standard output is the result (one JSON
object); the numbers compared, each with its limit, are the last lines of
standard error and the result's last key.

``--control`` prints, in place of a run, the readings the limits were set
from: the reference in TF32 against the reference (and, for a training
cell, the fault of half the pixels left out of the loss).

It needs a CUDA card: without one it exits with 2 and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "cpp_cuda_raytracer_dev_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def result_line(cell, run, out: dict, ok: bool, judged: dict) -> dict:
    from benchmark.harness import trace as trace_mod

    dev = run.device
    line = {"correct": ok, "attempted": out["attempted"],
            "failed": out["failed"]}
    if run.trace:
        tr = out["trace"]
        metrics = {}
        for m in cell.per_layer:
            v = trace_mod.reader(m["name"])(tr)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(out["end_to_end"], setup_s=run.setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    line["metrics"] = metrics
    line["device"] = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                      "kind": run.device_kind(),
                      "count": cell.chips if dev.type == "cuda" else 1,
                      "memory_peak_bytes": out["memory"]}
    if run.trace:
        tr = out["trace"]
        line["device"]["busy_s"] = tr.busy_us() * 1e-6
        line["device"]["window_s"] = tr.window_us * 1e-6
        line["breakdown"] = trace_mod.breakdown(tr)
    line["checks"] = judged
    return line


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t0: float = T0, control: bool = False) -> dict:
    """One run of ``cell`` on ``device``: the result's dict (``--control``:
    the control's readings)."""
    import torch
    from benchmark.harness import check, plugins, scene
    from benchmark.harness.runtime import Run

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = Run(cell, seed, seconds, trace, torch.device(device), t0)
    kind = plugins.load("kinds", cell.traffic["kind"])
    if control:
        return kind.control(run)
    scene.build_kernels(cell.config, run.device)
    out = kind.run(run)
    ok, judged = check.judge(out["numbers"], cell.limits)
    if out["note"]:
        run.log(out["note"])
    return result_line(cell, run, out, ok and out["failed"] == 0, judged)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import cells

    cell = cells.load(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < \
            cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   control=args.control)
    found = forbidden_modules()
    if found:
        print(f"loaded modules of JAX or the JAX package: {found}",
              file=sys.stderr)
        return 3
    if args.control:
        print(json.dumps(out))
        return 0
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
