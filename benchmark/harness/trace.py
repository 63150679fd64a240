"""The traced stretch of a run and what the per-layer readers see of it.

`profile` runs a stretch of frames or steps under ``torch.profiler`` (the
CUPTI trace of the card) with a span of the benchmark's own around each
one, and returns a `Trace`: the device operations (kernels, copies,
fills) with their start and end, the host's events, the stretch's window
(the first span's start to the last span's end, after a synchronise) and
how many frames or steps it held. A per-layer metric is a reader of its
own, ``metrics/<metric>.py``, whose ``read(trace)`` returns a number or
None where it finds nothing to read (its kernel is not on the path)."""

from __future__ import annotations

import dataclasses

from . import plugins

SPAN = "bench.unit"           # the benchmark's span around a frame or step


@dataclasses.dataclass
class Trace:
    kind: str                 # "serve" or "train"
    units: int                # frames or steps in the stretch
    window: tuple             # (start, end) in microseconds
    device: list              # (name, start_us, end_us), by start
    host: list                # (name, start_us, end_us) of host events
    shapes: dict              # "rays", "triangles"
    device_kind: str          # torch.cuda.get_device_name()

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def busy_us(self) -> float:
        """The union of the device operations' intervals in the window."""
        lo, hi = self.window
        busy, cur_s, cur_e = 0.0, None, None
        for _, s, e in self.device:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy

    def gaps(self) -> list:
        """(start, end) of every stretch of the window with no device
        operation running."""
        out, t = [], self.window[0]
        for _, s, e in self.device:
            if s > t:
                out.append((t, min(s, self.window[1])))
            t = max(t, e)
            if t >= self.window[1]:
                break
        if t < self.window[1]:
            out.append((t, self.window[1]))
        return [(s, e) for s, e in out if e > s]

    def named(self, *parts: str) -> list:
        """The device operations whose name contains any of ``parts``."""
        return [ev for ev in self.device if any(p in ev[0] for p in parts)]


def profile(run_unit, n: int, kind: str, shapes: dict, device_kind: str,
            sync) -> Trace:
    """Run ``run_unit(i)`` for i in range(n) under the profiler, each inside
    the span `SPAN`, then ``sync()``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with torch_profile(activities=acts) as prof:
        for i in range(n):
            with torch.profiler.record_function(SPAN):
                run_unit(i)
                if i == n - 1:
                    sync()
    device, host, spans = [], [], []
    for ev in prof.events():
        tr = (ev.name, float(ev.time_range.start), float(ev.time_range.end))
        if ev.device_type == DeviceType.CUDA:
            if ev.name != SPAN:        # the span's own mark on the device
                device.append(tr)
        else:
            host.append(tr)
            if ev.name == SPAN:
                spans.append(tr)
    device.sort(key=lambda x: x[1])
    window = (min(s for _, s, _ in spans), max(e for _, _, e in spans))
    return Trace(kind, n, window, device, host, shapes, device_kind)


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps summed by the innermost host event under each (seconds over the
    traced stretch)."""
    ops: dict = {}
    for name, s, e in trace.device:
        ops[name] = ops.get(name, 0.0) + (e - s) * 1e-6
    idle: dict = {}
    host = sorted(trace.host, key=lambda x: x[1])
    for gs, ge in trace.gaps():
        mid = (gs + ge) / 2
        under = [h for h in host if h[1] <= mid <= h[2]]
        name = (min(under, key=lambda h: h[2] - h[1])[0] if under
                else "no host event")
        idle[name] = idle.get(name, 0.0) + (ge - gs) * 1e-6

    def best(d):
        return [[k[:120], v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": best(ops), "idle_gaps": best(idle)}


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    return plugins.load("metrics", name).read
