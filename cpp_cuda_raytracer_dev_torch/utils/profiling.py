"""Tracing and timing (the JAX package's ``utils/profiling.py``).

The reference's observability is QueryPerformanceCounter wall timers around
scene load / sort / KD build plus a per-frame FPS HUD redrawn with VT escape
codes (``TEST_Dungeonrun/WinMain.cpp:47-48,122-151,219-235``). Here:

- `span(name)`: a named range of the program (every name starts with
  ``rt.``) in the host timeline of a running ``torch.profiler``, the clock
  its CUPTI device trace is aligned to; a span nests in the span that
  encloses it. With no profiler recording it is a shared null context,
  one flag check. The spans: ``rt.render_jit`` (`render_jit`'s whole
  call), ``rt.train_step`` (`make_train_step_jit`'s step), inside them
  ``rt.graphs.launch`` (each replay of a captured graph),
  ``rt.graphs.live`` (the host's read of the live count, a wait on the
  device) and ``rt.graphs.regrow`` (a live count that outgrew its bucket:
  the frame is redone at a larger one).
- `SETUP_S` and `tally(name)`: process-wide set-up seconds by cause, on the
  host's clock: ``capture_s`` (every probe frame, and every warm-up and
  capture of a graph), ``kd_build_s`` (the KD tree's build and its tables'
  upload).
- `bin_fill()`: the live entry count of each bin table of the last frame
  `render_jit` ran (its last replay on the card) and the tables' shared
  capacity, read when asked: the program keeps the counts a frame makes
  anyway, so a frame makes no read and launches nothing for it.
- `escalate_fill()`: the same for "pallas2"'s exact escalation
  (``escalate_all``): each object's tiles with overflow, all escalated, in
  the last frame, and the bucket of tiles escalated.
- `trace(dir)`: context manager around ``torch.profiler.profile`` (CPU and,
  where there is one, the CUDA device); writes a Chrome trace on exit,
  which shows the spans above the kernels they launch.
- `device_time`: seconds per call. On a CUDA device it reads CUDA events
  around a run of calls; on the CPU, which the caller must ask for, it
  reads the wall clock.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch
from torch.autograd import profiler as _autograd_profiler

DEFAULT_TRACE_DIR = Path(__file__).resolve().parents[2] / "build" / "trace"

_IDLE = contextlib.nullcontext()

# set-up seconds by cause, summed over the process (`tally`)
SETUP_S = {"capture_s": 0.0, "kd_build_s": 0.0}


def span(name: str):
    """A context for the program's range ``name``: a host range of the
    profiler while ``torch.profiler`` records (its module flag, set while
    any profiler runs), the shared null context otherwise.

    The range is a ``_RecordFunctionFast``, a host operation: a
    ``record_function`` range also leaves a copy of itself among the
    device's events, spanning the first to the last kernel launched
    inside it (torch 2.11 on an H100), which a reader of the device trace
    would count as device work."""
    if not _autograd_profiler._is_profiler_enabled:
        return _IDLE
    return torch._C._profiler._RecordFunctionFast(name)


@contextlib.contextmanager
def tally(name: str):
    """Add the host seconds of the block to ``SETUP_S[name]``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        SETUP_S[name] += time.perf_counter() - t0


def bin_fill() -> tuple[list[int], int] | None:
    """([live entries of each object's bin table], their capacity) of the
    last frame run by `render_jit`, or None where that frame built no bin
    tables. Reads the counts from the device: call it outside the frames
    being timed."""
    from ..accel.binning import BinBudget
    from ..models import renderer
    return renderer.FRAME_GRAPHS.fill(BinBudget)


def escalate_fill() -> tuple[list[int], int] | None:
    """([tiles with overflow of each object], the bucket of tiles
    escalated) of the last frame run by `render_jit` with "pallas2"'s
    exact escalation, or None where that frame had none. Reads the counts
    from the device: call it outside the frames being timed."""
    from ..accel.traverse import EscalateBudget
    from ..models import renderer
    return renderer.FRAME_GRAPHS.fill(EscalateBudget)


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
