"""Numerical-failure detection (the JAX package's ``utils/debug.py``).

The reference has no sanitizer story at all: kernel errors are printed
and execution continues (``TEST_Dungeonrun/Trixel.cu:227-237``). Two debug
entry points:

- `checked_render`: one frame, then a check of every float output of the
  frame; returns ``(error, frame)``, where the error names the first output
  that holds a NaN or an Inf. A kernel's output is checked where the frame
  consumes it, which is where a kernel NaN would surface.
- `debug_nans`: a scoped switch under which any operator that produces a
  NaN, forward or backward, raises ``FloatingPointError`` naming the
  operator (the heavier hammer for localising a NaN that `checked_render`
  reported). It reads every result back to the host: a debug mode, slow.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


@dataclasses.dataclass
class FrameError:
    """The result of `checked_render`'s check: ``message`` is None for a
    clean frame."""

    message: str | None = None

    def get(self) -> str | None:
        return self.message

    def throw(self) -> None:
        """Raise ValueError when the frame held a NaN or an Inf."""
        if self.message is not None:
            raise ValueError(self.message)


def checked_render(scene, camera, config, accel=None):
    """Render one frame and check its float outputs.

    Returns ``(error, RenderOutput)``; ``error.get()`` is None for a clean
    frame, else a message naming the first non-finite output. Usage::

        err, frame = checked_render(scene, camera, config)
        err.throw()   # raises ValueError on NaN/Inf in the frame
    """
    from ..models.renderer import render

    frame = render(scene, camera, config, accel)
    for f in dataclasses.fields(frame):
        x = getattr(frame, f.name)
        if not x.is_floating_point():
            continue
        bad = ~torch.isfinite(x)
        if bool(bad.any()):
            n_nan = int(torch.isnan(x).sum())
            return FrameError(
                f"non-finite {f.name}: {int(bad.sum())} of {x.numel()} "
                f"values ({n_nan} NaN), first at flat index "
                f"{int(bad.reshape(-1).nonzero()[0, 0])}"), frame
    return FrameError(), frame


_aten = torch.ops.aten
# allocators return uninitialised memory, which may read as NaN
_ALLOCATORS = (_aten.empty, _aten.empty_like, _aten.empty_strided,
               _aten.new_empty, _aten.new_empty_strided)


class _NanCheck(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket in _ALLOCATORS:
            return out
        for x in tree_leaves(out):
            if (isinstance(x, torch.Tensor) and x.is_floating_point()
                    and bool(torch.isnan(x).any())):
                raise FloatingPointError(f"NaN produced by {func}")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Scoped NaN check: inside, an operator that produces a NaN raises
    FloatingPointError at that operator, in the forward and in the backward
    (autograd's anomaly mode then also records the forward operator of a
    failing backward)."""
    if not enable:
        yield
        return
    with torch.autograd.set_detect_anomaly(True), _NanCheck():
        yield
