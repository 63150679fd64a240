"""Segment sum: per-id sums of (R, F) rows taken in sort order, the
backward of the packed row gather (kernel K2 of the JAX package,
``_segsum_kernel`` in ``ops/gather.py``).

- `segment_sum` is the wrapper. For CUDA tensors it launches the
  hand-written kernel in ``csrc/segment_sum.cu`` (deterministic: bitwise
  the same result on every call), which reads the rows through the sort
  order itself, and raises if the launch fails; for CPU tensors it runs
  `segment_sum_reference`. Nothing falls back from the card to the plain
  version.
- `segment_sum_reference` is the plain PyTorch version: the rows permuted
  into sort order, then ``index_add_`` into zeros (sequential, in row
  order, on the CPU).
- `segment_sum.launches` counts kernel launches; inside a captured CUDA
  graph (`make_train_step_jit`) that is the capture's launch, not the
  replays' (chip_smoke.py counts a replay's kernels in the profiler).

The two sum in different orders, so they agree to a float32 rounding
bound, not bit for bit: within n·2⁻²³·Σ|x| of the exact sum for a segment
of n rows.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_FEATURES = 16                  # a row's features live in registers
_fn = []


def _lib():
    if not _fn:
        lib = _build.load("segment_sum")
        lib.segment_sum_scratch_rows.argtypes = [ctypes.c_longlong]
        lib.segment_sum_scratch_rows.restype = ctypes.c_longlong
        lib.segment_sum_launch.argtypes = ([ctypes.c_void_p] * 3
                                           + [ctypes.c_int] * 2
                                           + [ctypes.c_void_p] * 4)
        lib.segment_sum_launch.restype = ctypes.c_int
        _fn.append(lib)
    return _fn[0]


def _check(block, idx_sorted, t_rows, order):
    if block.dim() != 2 or block.dtype != torch.float32:
        raise ValueError(f"block must be (R, F) float32, got "
                         f"{tuple(block.shape)} {block.dtype}")
    if idx_sorted.shape != block.shape[:1] or idx_sorted.dtype != torch.int32:
        raise ValueError("idx must be (R,) int32")
    if order is not None and (order.shape != idx_sorted.shape
                              or order.dtype != torch.int64):
        raise ValueError("order must be (R,) int64")
    if t_rows < 0 or (block.shape[0] and t_rows == 0):
        raise ValueError(f"t_rows {t_rows} cannot hold the ids")
    for name, x in (("block", block), ("idx", idx_sorted), ("order", order)):
        if x is None:
            continue
        if x.device != block.device:
            raise ValueError(f"{name} is on {x.device}, block on "
                             f"{block.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def segment_sum(block: torch.Tensor, idx_sorted: torch.Tensor, t_rows: int,
                order: torch.Tensor | None = None) -> torch.Tensor:
    """block: (R, F) f32 rows; order: (R,) i64 permutation, so that row i
    of the sorted sequence is block[order[i]] (block[i] without ``order``);
    idx_sorted: (R,) i32 ascending, row i's id, every id in [0, t_rows).
    Returns (t_rows, F) f32 with row t the sum of the rows with id t (0
    where there is none)."""
    _check(block, idx_sorted, t_rows, order)
    dev = block.device
    if dev.type == "cpu":
        return segment_sum_reference(block, idx_sorted, t_rows, order)
    if dev.type != "cuda":
        raise ValueError(f"no segment_sum kernel for {dev}")
    r, f = block.shape
    if f > MAX_FEATURES:
        raise ValueError(f"F = {f} features: the kernel holds at most "
                         f"{MAX_FEATURES} a row")
    out = torch.zeros((t_rows, f), dtype=torch.float32, device=dev)
    if r == 0 or f == 0:
        return out
    lib = _lib()
    n_part = max(1, lib.segment_sum_scratch_rows(r))
    part_id = torch.empty((n_part,), dtype=torch.int32, device=dev)
    part_val = torch.empty((n_part, f), dtype=torch.float32, device=dev)
    err = lib.segment_sum_launch(
        block.data_ptr(), None if order is None else order.data_ptr(),
        idx_sorted.data_ptr(), r, f, out.data_ptr(), part_id.data_ptr(),
        part_val.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"segment_sum kernel launch failed: CUDA error "
                           f"{err}")
    segment_sum.launches += 1
    return out


segment_sum.launches = 0


def segment_sum_reference(block: torch.Tensor, idx_sorted: torch.Tensor,
                          t_rows: int,
                          order: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of `segment_sum` (same contract)."""
    rows = block if order is None else block.index_select(0, order)
    out = torch.zeros((t_rows, block.shape[1]), dtype=torch.float32,
                      device=block.device)
    return out.index_add_(0, idx_sorted, rows)
