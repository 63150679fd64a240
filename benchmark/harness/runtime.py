"""What a run of a cell carries: its arguments, the device, the clocks and
the set-up time."""

from __future__ import annotations

import dataclasses
import sys
import time

import torch


class FrameClock:
    """A frame's latency in milliseconds: CUDA events around it on the
    card (``stop`` waits for the end event), the host's clock on the
    CPU."""

    def __init__(self, dev):
        self.cuda = dev.type == "cuda"
        if self.cuda:
            self.a = torch.cuda.Event(enable_timing=True)
            self.b = torch.cuda.Event(enable_timing=True)

    def start(self) -> None:
        if self.cuda:
            self.a.record()
        else:
            self.t = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            self.b.record()
            self.b.synchronize()
            return self.a.elapsed_time(self.b)
        return (time.perf_counter() - self.t) * 1e3


@dataclasses.dataclass
class Run:
    cell: object
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float                       # the process's start, host clock
    setup_s: float | None = None

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def clock(self) -> FrameClock:
        return FrameClock(self.device)

    def window_start(self, excluded_s: float = 0.0) -> float:
        """Marks the end of set-up, less ``excluded_s`` seconds of it that
        the reference took; returns the window's start."""
        self.sync()
        now = time.perf_counter()
        self.setup_s = now - self.t0 - excluded_s
        return now

    def memory_peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def device_kind(self) -> str:
        if self.device.type != "cuda":
            return "cpu"
        return torch.cuda.get_device_name(self.device)

    @staticmethod
    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)
