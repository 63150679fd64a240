"""The capture cache: the port's counterpart of ``jax.jit`` for a frame or
a training step (`models/renderer.py` `render_jit`,
`parallel/render_pjit.py` `make_train_step_jit`).

On CUDA a program (``body(args, bucket) -> (outputs, live)``) is captured
once per key and bucket into a ``torch.cuda.CUDAGraph`` and replayed:

- Key: what the trace depends on (the method and the config, the leaves'
  shapes, dtypes and device, the ``accel`` object), given by the caller.
- Static inputs: the first call of a key deep-copies the caller's
  arguments; every call copies the caller's leaves into that copy with one
  ``torch._foreach_copy_``, and the graph reads the copy.
- Warm-up: one call on a side stream before each capture, so that kernels
  are built and loaded and the allocator has settled. It runs the body,
  which never steps an optimizer.
- One memory pool serves every graph of a cache. Outputs live in it, so
  each call returns clones of them, which no later replay overwrites.
- Bucket: a program whose bin tables are sized at a capacity bucket
  (`accel/binning.py` `bin_budget`) returns their largest live count as
  ``live``. The first call of a key takes its bucket from a probe (the live
  count of an uncaptured frame): the next power of two at or above it, a
  multiple of ``chunk``. After each replay the host reads the live count
  (8 bytes, the only sync); above the bucket, the result is thrown away and
  the program is captured again at the bucket that holds it and replayed.
  The bucket never shrinks. A capture that fails raises: nothing falls back
  to the uncaptured program.

On the CPU there is no graph: the body runs on the caller's arguments at
the same bucket, with the same growth check.
"""

from __future__ import annotations

import copy
import dataclasses

import torch


def next_bucket(live: int, chunk: int) -> int:
    """The smallest power of two at or above ``live``, at least ``chunk``
    (a power of two, so the bucket is a multiple of it)."""
    return max(1 << max(int(live) - 1, 0).bit_length(), chunk)


def leaves(args) -> list[torch.Tensor]:
    """The input tensors of a module, a tensor, or a tuple of them, in a
    fixed order (a parameter shared by two modules counts once)."""
    if isinstance(args, torch.Tensor):
        return [args]
    if isinstance(args, torch.nn.Module):
        return [*args.parameters(), *args.buffers()]
    out, seen = [], set()
    for a in args:
        for t in leaves(a):
            if id(t) not in seen:
                seen.add(id(t))
                out.append(t)
    return out


def signature(args) -> tuple:
    """Shapes, dtypes and devices of the leaves (part of every key)."""
    return tuple((tuple(t.shape), t.dtype, t.device) for t in leaves(args))


def clone(out):
    """A copy of a tensor or of a dataclass of tensors."""
    if isinstance(out, torch.Tensor):
        return out.clone()
    return dataclasses.replace(out, **{f.name: getattr(out, f.name).clone()
                                       for f in dataclasses.fields(out)})


@dataclasses.dataclass
class Captured:
    """One captured program: its graph and its static outputs."""

    graph: torch.cuda.CUDAGraph
    out: object
    live: torch.Tensor | None


def capture(body, args, bucket, pool) -> Captured:
    """Warm ``body(args, bucket)`` up on a side stream, then capture one
    call of it into a new graph in ``pool``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body(args, bucket)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool):
        out, live = body(args, bucket)
    return Captured(graph, out, live)


class GraphCache:
    """Captured programs by key and bucket, in one memory pool. ``captures``
    counts the graphs captured and ``regrown`` the calls whose live count
    outgrew their bucket; ``buckets`` holds each key's bucket."""

    def __init__(self):
        self.pool = None
        self.static: dict = {}      # key -> (static args, their leaves)
        self.graphs: dict = {}      # (key, bucket) -> Captured
        self.buckets: dict = {}     # key -> bucket
        self.pinned: dict = {}      # key -> objects the key names by id
        self.captures = 0
        self.regrown = 0

    def bucket(self, key, args, probe, chunk: int | None) -> int | None:
        """The key's bucket; the first call of a key takes it from
        ``probe(args)``. None for a program without bin tables."""
        if probe is None:
            return None
        if key not in self.buckets:
            self.buckets[key] = next_bucket(probe(args), chunk)
        return self.buckets[key]

    def grow(self, key, live, bucket, chunk) -> int | None:
        """After a run at ``bucket``: None when its ``live`` count fits,
        else the larger bucket to redo it at (one host read of 8 bytes)."""
        if live is None:
            return None
        n = int(live)
        if n <= bucket:
            return None
        self.regrown += 1
        self.graphs.pop((key, bucket), None)    # the bucket never shrinks
        self.buckets[key] = next_bucket(n, chunk)
        return self.buckets[key]

    def program(self, key, args, body, bucket) -> Captured:
        """The key's graph at ``bucket``, captured on first use, its static
        inputs loaded with the caller's leaves."""
        if key not in self.static:
            static = copy.deepcopy(args)
            self.static[key] = (static, leaves(static))
        static, static_leaves = self.static[key]
        with torch.no_grad():
            torch._foreach_copy_(static_leaves, leaves(args))
        if (key, bucket) not in self.graphs:
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            self.graphs[key, bucket] = capture(body, static, bucket,
                                               self.pool)
            self.captures += 1
        return self.graphs[key, bucket]

    def run(self, key, args, body, probe=None, chunk: int | None = None,
            pin=None):
        """``body(args, bucket)``'s outputs for the caller's ``args``: on
        CUDA replayed from the key's graph and cloned, on the CPU run as
        is; redone at a larger bucket while the live count outgrows it.
        ``pin``: objects the key names by ``id``, kept alive as long as the
        key."""
        self.pinned.setdefault(key, pin)
        bucket = self.bucket(key, args, probe, chunk)
        on_cuda = leaves(args)[0].device.type == "cuda"
        while True:
            if on_cuda:
                prog = self.program(key, args, body, bucket)
                prog.graph.replay()
                out, live = prog.out, prog.live
            else:
                out, live = body(args, bucket)
            grown = self.grow(key, live, bucket, chunk)
            if grown is None:
                return clone(out) if on_cuda else out
            bucket = grown
