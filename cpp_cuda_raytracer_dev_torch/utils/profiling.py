"""Tracing, timing, and per-frame metrics (the JAX package's
``utils/profiling.py``).

The reference's observability is QueryPerformanceCounter wall timers around
scene load / sort / KD build plus a per-frame FPS HUD redrawn with VT escape
codes (``TEST_Dungeonrun/WinMain.cpp:47-48,122-151,219-235``). Here:

- `trace(dir)`: context manager around ``torch.profiler.profile`` (CPU and,
  where there is one, the CUDA device); writes a Chrome trace on exit.
- `Timer`: named wall-clock phase timers with a printable report.
- `FrameMetrics` / `metrics_line`: the per-frame HUD numbers.
- `timed` and `device_time`: seconds per call. On a CUDA device
  `device_time` reads CUDA events around a run of calls; on the CPU, which
  the caller must ask for, it reads the wall clock.

A timer handed a CUDA tensor (``fence``) synchronises its device before it
reads the clock, so a timed region measures device work, not the enqueue.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from pathlib import Path
from typing import Any

import torch

DEFAULT_TRACE_DIR = Path(__file__).resolve().parents[2] / "build" / "trace"


def _sync(x: Any) -> None:
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


def _sync_cuda() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str | Path = DEFAULT_TRACE_DIR):
    """Profile a region; writes ``<log_dir>/trace.json`` (Chrome trace) and
    yields the profiler, whose ``key_averages()`` sum the kernels."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        _sync_cuda()
    prof.export_chrome_trace(str(log_dir / "trace.json"))


class Timer:
    """Named phase timers: ``with timer.phase("kd build"): ...``."""

    def __init__(self) -> None:
        self.phases: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str, fence: Any = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync(fence)
            self.phases[name] = (time.perf_counter() - t0
                                 + self.phases.get(name, 0.0))

    def report(self) -> str:
        width = max((len(k) for k in self.phases), default=0)
        return "\n".join(f"{k:<{width}}  {v * 1e3:10.2f} ms"
                         for k, v in self.phases.items())


@dataclasses.dataclass
class FrameMetrics:
    """Per-frame numbers the reference prints in its HUD
    (WinMain.cpp:226-234)."""

    frame_ms: float
    num_rays: int
    hit_rate: float = float("nan")

    @property
    def fps(self) -> float:
        return 1e3 / self.frame_ms if self.frame_ms > 0 else float("inf")

    @property
    def rays_per_sec(self) -> float:
        return self.num_rays / (self.frame_ms * 1e-3)


def metrics_line(m: FrameMetrics) -> str:
    return (f"{m.frame_ms:8.2f} ms  {m.fps:8.1f} FPS  "
            f"{m.rays_per_sec:.3e} rays/s  hit={m.hit_rate:.3f}")


def timed(fn, *args, iters: int = 10, warmup: int = 2) -> float:
    """Wall-clock seconds per call of ``fn(*args)``, after ``warmup``
    calls; the CUDA device, where there is one, is synchronised before the
    clock is read."""
    for _ in range(warmup):
        fn(*args)
    _sync_cuda()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync_cuda()
    return (time.perf_counter() - t0) / iters


def device_time(make_call, n_lo: int = 4, n_hi: int = 8, repeats: int = 3,
                device: torch.device | str | None = None) -> float:
    """Seconds per call of ``make_call(i)`` (i = 0, 1, ...), the median over
    ``repeats`` runs of ``n_hi`` calls after ``n_lo`` warm-up calls.

    On a CUDA device (the default where there is one) each run is timed by
    two CUDA events on the current stream, so a run measures the stream's
    time from the first call's first launch to the last call's end,
    idle gaps between launches included: the device time a frame holds the
    card. ``device="cpu"`` times with the wall clock instead; a CPU number
    is never a device time.
    """
    if device is None:
        device = "cuda" if torch.cuda.is_available() else None
    if device is None:
        raise RuntimeError("device_time found no CUDA device; pass "
                           "device='cpu' to time on the CPU")
    device = torch.device(device)
    for i in range(n_lo):
        make_call(i)
    i = n_lo
    est = []
    for _ in range(repeats):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(device)
            start.record()
            for _ in range(n_hi):
                make_call(i)
                i += 1
            end.record()
            torch.cuda.synchronize(device)
            est.append(start.elapsed_time(end) * 1e-3 / n_hi)
        else:
            t0 = time.perf_counter()
            for _ in range(n_hi):
                make_call(i)
                i += 1
            est.append((time.perf_counter() - t0) / n_hi)
    est.sort()
    return est[len(est) // 2]
