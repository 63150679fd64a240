"""The capture cache: the port's counterpart of ``jax.jit`` for a frame or
a training step (`models/renderer.py` `render_jit`,
`parallel/render_pjit.py` `make_train_step_jit`).

On CUDA a program (``body(args, bucket) -> (outputs, budget)``) is
captured once per key and bucket into a ``torch.cuda.CUDAGraph`` and
replayed, and a program that follows it (`GraphCache.follow`) once per
graph it follows:

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
- Bucket: a program whose tensors are sized at a bucket of a live count
  runs inside `sized` and returns its `Budget` (else None), which holds
  each table's live count and their largest, ``live``: the bin tables'
  entries (`accel/binning.py` `BinBudget`, an int bucket) or the tiles
  "pallas2" escalates and their candidates (`accel/traverse.py`
  `EscalateBudget`, a bucket of two ints, each count held to its own).
  The first call of a key takes its bucket from a probe (the live count of
  an uncaptured frame): the next power of two at or above it, at least
  ``chunk``. After each replay the host reads the live count (8 or 16
  bytes, the only sync); above the bucket, the result is thrown away and
  the program is captured again at the bucket that holds it and replayed.
  The bucket never shrinks. A capture that fails raises: nothing falls back
  to the uncaptured program.
- Fill: the cache keeps the budget of each key's last run (on CUDA the
  captured one, whose counts each replay rewrites), so `fill` reads how
  full the last frame's bucket was, when asked: a frame makes no read and
  launches nothing for it.
- Agreement (the sharded paths, `parallel/render_pjit.py`): every rank of
  a mesh replays its own graph, whose collectives pair up only if every
  rank replays, regrows, warms up and captures at the same calls. A cache
  built with ``agree`` (a count's maximum over the mesh) takes a key's
  first bucket from the largest probe of any rank and, after each replay,
  regrows when any rank's live count outgrew the bucket: one collective
  beside the host read. Keys are rank-local and are never exchanged: what
  keeps the ranks together is that every rank hits or misses its cache at
  the same call, which an SPMD program gives with the same keys as a single
  device (objects named by ``id`` are pinned, so no id is reused).

- Tracing (`utils/profiling.py`): each replay runs in the span
  ``rt.graphs.launch``, each host read of the live count in
  ``rt.graphs.live`` and each regrowth in ``rt.graphs.regrow``; every
  probe, warm-up and capture adds its host seconds to ``capture_s``.

On the CPU there is no graph: the body runs on the caller's arguments at
the same bucket, with the same growth check.
"""

from __future__ import annotations

import contextlib
import contextvars
import copy
import dataclasses

import torch

from .profiling import span, tally

# the span of a regrowth of a bucket (`GraphCache.grow`)
REGROW_SPAN = "rt.graphs.regrow"


def next_bucket(live, chunk):
    """The smallest power of two at or above ``live``, at least ``chunk``
    (a power of two, so the bucket is a multiple of it); elementwise where
    ``live`` and ``chunk`` are tuples."""
    if isinstance(live, tuple):
        return tuple(next_bucket(n, c) for n, c in zip(live, chunk))
    return max(1 << max(int(live) - 1, 0).bit_length(), chunk)


def _fits(live, bucket) -> bool:
    if isinstance(live, tuple):
        return all(n <= b for n, b in zip(live, bucket))
    return live <= bucket


def _larger(a, b):
    """The elementwise maximum of two buckets: a bucket never shrinks."""
    if isinstance(a, tuple):
        return tuple(max(x, y) for x, y in zip(a, b))
    return max(a, b)


@dataclasses.dataclass
class Budget:
    """The bucket every table of a frame is sized at (``capacity``), the
    live count of each table in the order they were built (``counts``, i64
    tensors on the device: a scalar, or one element for each int of a
    tuple bucket) and their (elementwise) largest, ``live`` (None until a
    table is built). Recording a count launches nothing for the first
    table, and one maximum for each later one."""

    capacity: int | tuple
    live: torch.Tensor | None = None
    counts: list = dataclasses.field(default_factory=list)

    def record(self, n: torch.Tensor) -> None:
        self.counts.append(n)
        self.live = n if self.live is None else torch.maximum(self.live, n)

    def fill(self) -> tuple[list[int], int]:
        """Each table's live count and the capacity (read from the
        device)."""
        return [int(n) for n in self.counts], self.capacity


_BUDGET: contextvars.ContextVar = contextvars.ContextVar("budget",
                                                         default=None)


@contextlib.contextmanager
def sized(budget: Budget | None):
    """Inside, the renderer sizes the tables ``budget`` is for (its class:
    `models/renderer.py` `budget` picks it) at its capacity and records
    their live counts in it; None changes nothing. Yields ``budget``."""
    token = _BUDGET.set(budget)
    try:
        yield budget
    finally:
        _BUDGET.reset(token)


def active_budget() -> Budget | None:
    """The budget of `sized`, else None."""
    return _BUDGET.get()


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


def capture(fn, pool, warm_up: bool = True):
    """Capture one call of ``fn()`` into a new graph in ``pool``: (the
    graph, what the call returned). With ``warm_up`` one call on a side
    stream comes first; it also runs a program's collectives eagerly on
    every rank, which creates the NCCL communicator before the capture.
    torch.cuda.graph's default ``capture_error_mode`` ("global") is enough
    while ProcessGroupNCCL runs: on the H100 (torch 2.11, NCCL 2.28.9) an
    NCCL all-reduce and all-gather capture and replay bitwise in it, also
    with an eager collective of the same group still in flight when the
    capture begins. Its host seconds count in ``capture_s``
    (`utils/profiling.py` `SETUP_S`)."""
    with tally("capture_s"):
        if warm_up:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn()
            torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool):
            out = fn()
    return graph, out


class GraphCache:
    """Captured programs by key and bucket, in one memory pool. ``captures``
    counts the graphs captured and ``regrown`` the calls whose live count
    outgrew their bucket; ``buckets`` holds each key's bucket and
    ``tables`` the `Budget` of each key's last run (``last`` is the key
    run last, ``replayed`` the graph it replayed last, None on the CPU).

    ``agree``: None, or a function that returns the maximum over a mesh of
    a count (an int, or a tensor of one or two counts on the program's
    device) as an int or a tuple of ints; every count that picks or grows a
    bucket then goes through it."""

    def __init__(self, agree=None):
        self.agree = agree
        self.pool = None
        self.static: dict = {}      # key -> (static args, their leaves)
        self.graphs: dict = {}      # (key, bucket) -> `capture` result
        self.buckets: dict = {}     # key -> bucket
        self.pinned: dict = {}      # key -> objects the key names by id
        self.tables: dict = {}      # key -> Budget of its last run
        self.last = self.replayed = self.followed = self.follower = None
        self.captures = 0
        self.regrown = 0

    def count(self, n):
        """A live or probed count as an int (a tuple of ints for a tensor
        of several): read from the device, or with ``agree`` its maximum
        over the mesh."""
        if self.agree is not None:
            return self.agree(n)
        if isinstance(n, torch.Tensor) and n.dim():
            return tuple(n.tolist())
        return int(n)

    def bucket(self, key, args, probe, chunk):
        """The key's bucket; the first call of a key takes it from
        ``probe(args)`` (its host seconds count in ``capture_s``). None
        for a program without a bucket."""
        if probe is None:
            return None
        if key not in self.buckets:
            with tally("capture_s"):
                n = self.count(probe(args))
            self.buckets[key] = next_bucket(n, chunk)
        return self.buckets[key]

    def grow(self, key, budget, bucket, chunk):
        """After a run at ``bucket``: None when its ``budget``'s largest
        live count fits, else the larger bucket to redo it at (one host
        read of 8 or 16 bytes, in the span ``rt.graphs.live``; the
        regrowth in ``rt.graphs.regrow``)."""
        if budget is None or budget.live is None:
            return None
        with span("rt.graphs.live"):
            n = self.count(budget.live)
        if _fits(n, bucket):
            return None
        with span(REGROW_SPAN):
            self.regrown += 1
            self.graphs.pop((key, bucket), None)  # the bucket never shrinks
            self.buckets[key] = _larger(bucket, next_bucket(n, chunk))
        return self.buckets[key]

    def fill(self, kind: type) -> tuple[list[int], int] | None:
        """`Budget.fill` of the last run where its budget is a ``kind``
        (`accel/binning.py` `BinBudget`: the bin tables' entries;
        `accel/traverse.py` `EscalateBudget`: the tiles "pallas2" escalated
        and their bucket); None where that run built none. Reads the counts
        from the device."""
        budget = self.tables.get(self.last)
        if not isinstance(budget, kind) or not budget.counts:
            return None
        return budget.fill()

    def program(self, key, args, body, bucket):
        """The key's graph at ``bucket`` and its static outputs and budget,
        captured on first use, its static inputs loaded with the caller's
        leaves."""
        if key not in self.static:
            static = copy.deepcopy(args)
            self.static[key] = (static, leaves(static))
        static, static_leaves = self.static[key]
        with torch.no_grad():
            torch._foreach_copy_(static_leaves, leaves(args))
        if (key, bucket) not in self.graphs:
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            self.graphs[key, bucket] = capture(lambda: body(static, bucket),
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
                self.replayed, (out, budget) = self.program(key, args, body,
                                                            bucket)
                with span("rt.graphs.launch"):
                    self.replayed.replay()
            else:
                out, budget = body(args, bucket)
            self.tables[key], self.last = budget, key
            grown = self.grow(key, budget, bucket, chunk)
            if grown is None:
                return clone(out) if on_cuda else out
            bucket = grown

    def follow(self, fn) -> None:
        """``fn()`` after a `run` (the optimizer's step): eagerly on the CPU
        and after the first run, which no warm-up precedes; on CUDA later
        replayed from a graph captured without warm-up at the second run
        and again whenever the run replayed another graph. Its capture
        counts in ``capture_s``, not in ``captures``."""
        before, self.followed = self.followed, self.replayed
        if before is None:
            fn()
            return
        if self.follower is None or before is not self.replayed:
            self.follower = capture(fn, self.pool, warm_up=False)[0]
        self.follower.replay()
