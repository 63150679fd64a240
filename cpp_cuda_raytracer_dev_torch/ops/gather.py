"""Row gather of per-hit triangle data with a sorted segment-sum backward
(the JAX package's ``ops/gather.py``).

- Forward: every table is packed into one (T, F) block and gathered with a
  single ``index_select``.
- Backward (`segment_sum_rows`): a stable sort of the ids, then kernel K2
  (``ops/cuda/segment_sum.py``), which reads the (R, F) cotangent rows
  through the sort order. The stable sort fixes the row order inside each
  segment and with it every float32 sum.
- When no table needs a gradient (the pose/light/camera-only step), the
  Function is not entered: nothing is sorted and nothing launches.
- `take_rows` is the plain per-table ``index_select``, whose autograd
  backward is a scatter-add; ``RenderConfig(sorted_scatter=False)`` selects
  it, as the JAX package then uses ``jnp.take``.
"""

from __future__ import annotations

import torch

from .cuda import segment_sum as k2


def _pack(tables):
    flats = [t.reshape(t.shape[0], -1) for t in tables]
    return flats[0] if len(flats) == 1 else torch.cat(flats, dim=1)


def _unpack(block, shapes):
    out, off = [], 0
    for shape in shapes:
        w = shape[1:].numel()
        out.append(block[:, off:off + w].reshape(block.shape[0], *shape[1:]))
        off += w
    return tuple(out)


def segment_sum_rows(block: torch.Tensor, idx: torch.Tensor,
                     t_rows: int) -> torch.Tensor:
    """(t_rows, F) sums of the (R, F) rows of ``block`` by ``idx`` (R,):
    the VJP of ``index_select`` on a (t_rows, F) table."""
    idx_sorted, order = torch.sort(idx, stable=True)
    return k2.segment_sum(block.contiguous(), idx_sorted.to(torch.int32),
                          t_rows, order=order)


class _GatherRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, idx, *tables):
        ctx.shapes = [t.shape for t in tables]
        ctx.save_for_backward(idx)
        return tuple(r.contiguous() for r in
                     _unpack(_pack(tables).index_select(0, idx), ctx.shapes))

    @staticmethod
    def backward(ctx, *cts):
        # autograd calls this only when some table needs a gradient
        need = ctx.needs_input_grad[1:]
        idx, = ctx.saved_tensors
        seg = segment_sum_rows(_pack(cts), idx, ctx.shapes[0][0])
        grads = _unpack(seg, ctx.shapes)
        return (None, *(g if n else None for g, n in zip(grads, need)))


def gather_rows(tables, idx: torch.Tensor):
    """tables: tuple of (T, ...) tensors (same T); idx: (R,) ids in [0, T).
    Returns the tuple of (R, ...) gathered rows, differentiable with
    respect to the tables."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tables):
        return _GatherRows.apply(idx, *tables)
    return _unpack(_pack(tables).index_select(0, idx),
                   [t.shape for t in tables])


def sums_by_k2(sorted_scatter: bool, dtype: torch.dtype) -> bool:
    """Whether the triangle rows' sums (a gather's backward) go through
    `segment_sum_rows` (kernel K2, which sums float32 rows; with
    ``sorted_scatter``) rather than a scatter-add (`take_rows`'s
    ``index_select`` backward, ``index_add_``)."""
    return sorted_scatter and dtype == torch.float32


def take_rows(tables, idx: torch.Tensor):
    """Per-table ``index_select`` with autograd's own backward."""
    return tuple(t.index_select(0, idx) for t in tables)
