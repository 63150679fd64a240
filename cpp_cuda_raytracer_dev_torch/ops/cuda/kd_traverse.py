"""KD traversal: the nearest hit per ray over a `KDTables` tree, kernel K7
(the counterpart of the JAX package's on-device loop in ``kd_intersect``,
``accel/traverse.py``; not a Pallas kernel).

- `kd_traverse` is the wrapper. For CUDA tensors it launches the
  hand-written kernel in ``csrc/kd_traverse.cu`` (one thread a ray, its own
  stack, the near-first exit) and raises if the launch fails or the tree or
  dtype is one it does not take; for CPU tensors it runs
  `kd_traverse_reference`. Nothing falls back from the card to the plain
  version.
- `kd_traverse_reference` is the plain PyTorch version: the reference's
  stack traversal in lockstep over rays, one (pop, test, push) step for all
  rays a loop iteration, until every stack is empty (a host read a step),
  with the near-first exit (``near_first=False``: without it, JAX's loop,
  the exit's exactness oracle). The kernel and it agree bit for bit in t
  and ids. The exit changes no t and no id, except possibly on a hit
  within about 6e-3 radians of its triangle's plane in float32 (1e-11 in
  float64), where MT's own t has lost its digits (`NEAR_REL`).
- `kd_traverse.launches` counts kernel launches; inside a captured CUDA
  graph (`render_jit`, `make_train_step_jit`) that is the capture's launch,
  not the replays' (chip_smoke.py counts a replay's kernels in the
  profiler).
- `LEVERS` names the kernel's design levers (``csrc/kd_traverse.cu``);
  `_launch` takes a mask of them so that chip_smoke.py and the GPU tests
  can switch each off. No caller of `kd_traverse` sets them.

Operands: ``o`` (3,) the object-frame origin, ``d`` (R, 3) directions, of
one dtype, float32 or float64, which the tables' geometry (``slot_geom``,
of which ``p1``, ``e1`` and ``e2`` are views) shares; the kernel takes a
tree of at most `max_stack` - 2 levels (its stack has ``max_depth + 2``
entries). ``width`` > 0 says the rays are rows of an image that wide,
row-major (the kernel then gives a warp an 8x4 pixel block); it changes no
result. Returns (t (R,) in the rays' dtype, ``draw_distance`` on a miss;
tri (R,) int32 original triangle ids, -1 on a miss).
"""

from __future__ import annotations

import ctypes

import torch

from ...utils.dtypes import DEFAULT_DRAW_DISTANCE, MT_EPSILON, SLAB_EPSILON
from .. import vecmath
from . import _build

_DTYPES = (torch.float32, torch.float64)
_fn = []

# The near-first exit's margin. The exit slab-tests a popped node's box
# grown by a pad on every side, pad = NEAR_PAD * (max |o| + max |root box|)
# in the rays' dtype; it skips the node when that box's entry t exceeds
# best_t * (1 + NEAR_REL) + NEAR_ABS, and a leaf also when the ray misses
# that box or the box lies behind it by as much. For that to skip nothing
# that could change the result, the grown box must hold every point where
# MT can accept a triangle of the node, and its computed entry t must not
# exceed the computed MT t of such a hit by more than the margin:
# - every triangle lies in its leaf's box and in each ancestor's (a box is
#   the hull of its triangles' AABBs, accel/kd_build.py `node_bounds`, and
#   each triangle is in one leaf);
# - MT accepts a ray that misses a triangle by its rounding: u, v and t
#   are inv * dots of o - p1, d x e2 and (o - p1) x e1, about ten
#   roundings, so in space an accepted hit lies within a few ulps of |o -
#   p1| of the triangle, scaled by about 1 / sin of the angle between the
#   ray and the triangle's plane. On a ray parallel to a box face that
#   spatial miss is an infinite slab t (the grid scene of the tests: a
#   gap of 3e-17 beside a hit at t 1.5), so the margin has to be spatial:
#   the pad. It is 1e-4 of a length no smaller than |o - p1| (1,700 float32
#   ulps: hits down to about a third of a degree from their plane); it also
#   covers the float32 boxes (node_box) of float64 vertices, which may lie
#   2^-24 |b| inside the true hull, and MT_EPSILON's widening (1e-16 of the
#   edges);
# - along the ray, the slab t is (b - o) * (1 / d), three roundings, 3u
#   relative (u = 2^-24 in float32, 2^-53 in float64), min and max add
#   none, and MT's t is off by a few ulps, more on grazing hits: NEAR_REL
#   (1e-4 relative) covers that, and NEAR_ABS t near 0.
# A wider margin only skips less: it can never change t or an id, because
# the best changes only on a strictly smaller t.
# The argument does not hold for every hit. With every rounding at its
# worst, it covers hits at least about a third of a degree (6e-3 radians)
# off their triangle's plane in float32, and about 1e-11 radians in
# float64. MT's t and the point it names are off by about u / sin of that
# angle times |o - p1|, so a more grazing hit can lie outside the grown
# box; if another hit lies between its t and the box, the exit skips the
# node where the walk without it takes the grazing hit. No fixed pad
# removes that: MT's error grows without bound as the angle falls, and at
# such a hit MT's t is itself off the plane's by that much.
# The worst case is loose: rounding errors seldom align, and a difference
# needs a second hit in that gap. Tilted planes of 1,800 triangles stay
# bitwise the walk without the exit at 1e-4 and 1e-3 radians in float32
# (1e-12 and 1e-10 in float64) at leaf 1, 8 and 128; the first difference
# seen is at 1e-5 radians in float32, one ray in 3,000 at leaf 1 (MT's t
# 3.4e-3 short of the plane, the point 3.5e-3 outside its triangle's box,
# ten times the pad; chip_smoke.py phase 16 counts such rays). Held
# bitwise against the walk without the exit in tests/test_torch_kd.py and
# chip_smoke.py phase 16 (those planes, and every headline ray, in float32
# and float64).
NEAR_REL = 1e-4
NEAR_ABS = 1e-4
NEAR_PAD = 1e-4

# K7's design levers, one bit each (csrc/kd_traverse.cu): (a) the near-first
# exit, (b) 16-byte slot loads, (d) 8x4 pixel blocks a warp. `DESIGN`, the
# mask the wrapper launches, holds all three; chip_smoke.py phase 16 times
# each against its absence.
LEVERS = {"near_first": 1, "packed": 2, "warp_blocks": 4}
DESIGN = sum(LEVERS.values())


def _lib():
    if not _fn:
        lib = _build.load("kd_traverse")
        for name in ("kd_traverse_max_stack", "kd_traverse_all_levers"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
        lib.kd_traverse_launch.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
            + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
            + [ctypes.c_double] * 6 + [ctypes.c_void_p] * 3)
        lib.kd_traverse_launch.restype = ctypes.c_int
        if lib.kd_traverse_all_levers() != sum(LEVERS.values()):
            raise RuntimeError("kd_traverse.cu and LEVERS name other levers")
        _fn.append(lib)
    return _fn[0]


def max_stack() -> int:
    """The deepest stack the kernel holds (``max_depth + 2`` of a tree)."""
    return _lib().kd_traverse_max_stack()


def _check(o, d, tables):
    if d.dim() != 2 or d.shape[1] != 3 or o.shape != (3,):
        raise ValueError(f"rays must be o (3,) and d (R, 3), got "
                         f"{tuple(o.shape)} and {tuple(d.shape)}")
    if d.dtype not in _DTYPES or o.dtype != d.dtype \
            or tables.p1.dtype != d.dtype:
        raise TypeError(f"kd_traverse takes float32 or float64 rays with "
                        f"geometry of the same dtype, got o {o.dtype}, d "
                        f"{d.dtype}, geometry {tables.p1.dtype}")
    if o.device != d.device:
        raise ValueError(f"o is on {o.device}, d on {d.device}")
    n_nodes, n_tris = tables.node_link.shape[0], tables.perm.shape[0]
    for name, shape, dtype in (
            ("node_box", (n_nodes, 8), torch.float32),
            ("node_link", (n_nodes, 4), torch.int32),
            ("perm", (n_tris,), torch.int32),
            ("slot_geom", (n_tris, 12), d.dtype)):
        x = getattr(tables, name)
        if x.shape != shape or x.dtype != dtype:
            raise ValueError(f"{name} must be {shape} {dtype}, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if x.device != d.device or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {d.device}")


def kd_traverse(o: torch.Tensor, d: torch.Tensor, tables,
                draw_distance: float = DEFAULT_DRAW_DISTANCE,
                eps: float = MT_EPSILON, ray_chunk: int = 32768,
                width: int = 0):
    """(t, tri) of the nearest hit of each ray ``o + t d`` over ``tables``
    (a `KDTables`). ``ray_chunk`` bounds the plain version's per-ray state
    (0: all rays at once) and changes no result; the kernel ignores it, as
    the plain version ignores ``width``."""
    _check(o, d, tables)
    dev = d.device
    if dev.type == "cpu":
        return kd_traverse_reference(o, d, tables, draw_distance, eps,
                                     ray_chunk)
    t, tri = _launch(o, d, tables, draw_distance, eps, width, DESIGN)
    kd_traverse.launches += 1
    return t, tri


kd_traverse.launches = 0


def _launch(o, d, tables, draw_distance, eps, width, levers):
    """Launch K7 with the design levers in the mask ``levers`` (`LEVERS`)
    on checked operands; returns (t, tri). Counts nothing."""
    dev = d.device
    if dev.type != "cuda":
        raise ValueError(f"no kd_traverse kernel for {dev}")
    depth = tables.max_depth + 2
    if depth > max_stack():
        raise ValueError(f"a KD tree of depth {tables.max_depth} needs a "
                         f"stack of {depth}; the kernel holds {max_stack()}")
    if width < 0 or levers & ~DESIGN:
        raise ValueError(f"width {width} or levers {levers} out of range")
    if tables.slot_geom.data_ptr() % 16:
        raise ValueError("slot_geom must be 16-byte aligned")
    num_r = d.shape[0]
    t = torch.empty((num_r,), dtype=d.dtype, device=dev)
    tri = torch.empty((num_r,), dtype=torch.int32, device=dev)
    if num_r == 0:
        return t, tri
    o, d = o.contiguous(), d.contiguous()
    err = _lib().kd_traverse_launch(
        o.data_ptr(), d.data_ptr(), num_r, width, tables.node_box.data_ptr(),
        tables.node_link.data_ptr(), tables.slot_geom.data_ptr(),
        tables.perm.data_ptr(), depth, int(d.dtype == torch.float64), levers,
        float(draw_distance), float(eps), float(SLAB_EPSILON),
        1.0 + NEAR_REL, NEAR_ABS, NEAR_PAD, t.data_ptr(), tri.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"kd_traverse kernel launch failed: CUDA error "
                           f"{err}")
    return t, tri


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``vecmath.dot`` summed as (x + y) + z, the kernel's order."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) \
        + a[..., 2] * b[..., 2]


def _mt(o, d, p1, e1, e2, eps):
    """``ops/intersect.py`` `mt_test`'s t and acceptance, with `_dot`."""
    pvec = vecmath.cross(d, e2)
    det = _dot(e1, pvec)
    tvec = o - p1
    qvec = vecmath.cross(tvec, e1)
    inv = torch.reciprocal(torch.where(det == 0.0, 1.0, det))
    u = inv * _dot(tvec, pvec)
    v = inv * _dot(d, qvec)
    t = inv * _dot(e2, qvec)
    valid = ((det.abs() >= eps) & (u >= eps) & (v >= eps)
             & (u + v <= 1.0 + eps) & (t >= eps))
    return t, valid


@torch.no_grad()
def kd_traverse_reference(o: torch.Tensor, d: torch.Tensor, tables,
                          draw_distance: float = DEFAULT_DRAW_DISTANCE,
                          eps: float = MT_EPSILON, ray_chunk: int = 32768,
                          counts: dict | None = None,
                          near_first: bool = True):
    """Plain PyTorch version of `kd_traverse` (same contract): the
    reference's stack traversal, in lockstep over rays.

    Per step each ray with a non-empty stack pops a node and slab-tests it
    (Trixel.cu:76-95); at a leaf it intersects the leaf's triangles
    (Trixel.cu:98-145), the lowest slot winning at the leaf's minimum t and
    the best changing only on a strictly smaller t; at an internal node it
    pushes the children by the s1/s2 split-plane rule (Trixel.cu:146-169),
    the far one first. It runs until every stack is empty.

    With ``near_first`` (the default, and K7's rule) a popped node, leaf or
    internal, is skipped when its box's slab entry t lies beyond the ray's
    best t by more than a margin, and a popped leaf also when the ray
    misses its box by more than the margin; the exit tests the box grown by
    a spatial pad (`NEAR_REL`, `NEAR_ABS` and `NEAR_PAD`). Neither skip
    changes t or an id, except possibly on a hit within about 6e-3 radians
    of its triangle's plane in float32 (1e-11 in float64), where MT's own
    t has lost its digits (`NEAR_REL` says why, and what was measured). A
    NaN slab t keeps the node.
    ``near_first=False`` is the walk without the exit, JAX's loop: it
    serves only as the oracle of the exit's exactness.

    Rays go in runs of ``ray_chunk`` (0: all at once), which bound the
    per-ray state; the runs change no result. With ``counts`` (a dict) it
    adds the work it did as 0-d device tensors: ``slab_tests``, the pops
    that ran a slab test (every internal node; with ``near_first`` every
    leaf too), ``mt_pairs``, the (ray, leaf slot) pairs, and ``skipped``,
    the pops the exit dropped.
    """
    num_r = d.shape[0]
    if ray_chunk and num_r > ray_chunk:
        parts = [kd_traverse_reference(o, d[i:i + ray_chunk], tables,
                                       draw_distance, eps, 0, counts,
                                       near_first)
                 for i in range(0, num_r, ray_chunk)]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))
    dev = d.device
    depth = tables.max_depth + 2
    lmax = tables.max_leaf
    rows = torch.arange(num_r, device=dev)
    lanes = torch.arange(lmax, device=dev)
    stack = torch.zeros((num_r, depth), dtype=torch.int64, device=dev)
    sp = torch.zeros((num_r,), dtype=torch.int64, device=dev)  # root at 0
    best_t = torch.full((num_r,), draw_distance, dtype=d.dtype, device=dev)
    best_tri = torch.full((num_r,), -1, dtype=torch.int32, device=dev)
    inv_d = torch.reciprocal(d)
    # the margin's constants in the rays' dtype, as the kernel rounds them,
    # and the exit's spatial pad (see NEAR_REL)
    c_rel = torch.tensor(1.0 + NEAR_REL, dtype=d.dtype, device=dev)
    c_abs = torch.tensor(NEAR_ABS, dtype=d.dtype, device=dev)
    root = tables.node_box[0, [0, 1, 2, 4, 5, 6]]
    pad = (o.abs().amax() + root.abs().amax().to(d.dtype)) \
        * torch.tensor(NEAR_PAD, dtype=d.dtype, device=dev)
    if counts is not None:
        for k in ("slab_tests", "mt_pairs", "skipped"):
            counts.setdefault(k, torch.zeros((), dtype=torch.int64,
                                             device=dev))

    while bool((sp >= 0).any()):
        active = sp >= 0
        node = stack[rows, sp.clamp_min(0)]
        node = torch.where(active, node, 0)
        sp = torch.where(active, sp - 1, sp)

        t0 = (tables.bounds_min[node] - o) * inv_d
        t1 = (tables.bounds_max[node] - o) * inv_d
        t_entry = torch.minimum(t0, t1).amax(dim=-1)
        t_exit = torch.maximum(t0, t1).amin(dim=-1)
        # Trixel.cu:146: mint1 >= maxt0 - eps && maxt0 > -eps
        box_hit = ((t_exit >= t_entry - SLAB_EPSILON)
                   & (t_entry > -SLAB_EPSILON))

        leaf = tables.is_leaf[node]
        live = active
        if near_first:
            # the box grown by the pad: its entry beyond the best, or (a
            # leaf) the ray missing it or it lying behind the ray, each by
            # more than the margin; NaN keeps
            q0 = ((tables.bounds_min[node].to(d.dtype) - pad) - o) * inv_d
            q1 = ((tables.bounds_max[node].to(d.dtype) + pad) - o) * inv_d
            q_entry = torch.minimum(q0, q1).amax(dim=-1)
            t_far = torch.maximum(q0, q1).amin(dim=-1) * c_rel + c_abs
            skip = active & ((q_entry > best_t * c_rel + c_abs)
                             | (leaf & ((t_far < 0)
                                        | (q_entry > t_far * c_rel + c_abs))))
            live = active & ~skip
        # leaf: MT over the leaf's (padded) triangle range, for the rays
        # that popped a leaf only
        lr = torch.nonzero(live & leaf).squeeze(1)
        ln = node[lr]
        in_leaf = lanes < tables.leaf_count[ln][:, None]
        slot = torch.where(in_leaf, tables.leaf_start[ln][:, None] + lanes,
                           0)                                 # (n, lmax)
        t_mt, ok = _mt(o, d[lr, None, :], tables.p1[slot], tables.e1[slot],
                       tables.e2[slot], eps)
        t_mt = torch.where(in_leaf & ok, t_mt, torch.inf)
        tmin = t_mt.amin(dim=1)
        amin = torch.where(t_mt == tmin[:, None], lanes, lmax).amin(dim=1)
        tri = tables.perm[slot.gather(1, amin.clamp_max(lmax - 1)[:, None])
                          [:, 0]]
        better = tmin < best_t[lr]
        best_t[lr] = torch.where(better, tmin, best_t[lr])
        best_tri[lr] = torch.where(better, tri, best_tri[lr])

        # internal: push children near-to-far (reference s1/s2 rule)
        axis = tables.axis[node]
        d_ax = d.gather(1, axis[:, None])[:, 0]
        o_ax = o[axis]
        c_entry = o_ax + t_entry * d_ax
        c_exit = o_ax + t_exit * d_ax
        s1 = tables.s1[node] + SLAB_EPSILON
        s2 = tables.s2[node]
        go_left_first = c_entry < s2 + SLAB_EPSILON           # Trixel.cu:155
        also_right = c_exit > s2 - SLAB_EPSILON               # Trixel.cu:156
        also_left = (c_exit < s1) | (c_entry < s1)            # Trixel.cu:163

        expand = live & box_hit & ~leaf
        if counts is not None:
            counts["slab_tests"] += (active if near_first
                                     else active & ~leaf).sum()
            counts["mt_pairs"] += tables.leaf_count[ln].sum()
            counts["skipped"] += (active & ~live).sum()
        # the far child first, the near child last (popped first)
        lchild, rchild = tables.left[node], tables.right[node]
        far = torch.where(go_left_first, rchild, lchild)
        near = torch.where(go_left_first, lchild, rchild)
        for push, child in ((expand & torch.where(go_left_first, also_right,
                                                  also_left), far),
                            (expand, near)):
            sp = torch.where(push, sp + 1, sp)
            at = sp.clamp(0, depth - 1)
            stack[rows, at] = torch.where(push, child, stack[rows, at])
    return best_t, best_tri
