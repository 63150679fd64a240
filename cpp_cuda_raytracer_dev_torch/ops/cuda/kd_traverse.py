"""KD traversal: the nearest hit per ray over a `KDTables` tree, kernel K7
(the counterpart of the JAX package's on-device loop in ``kd_intersect``,
``accel/traverse.py``; not a Pallas kernel).

- `kd_traverse` is the wrapper. For CUDA tensors it launches the
  hand-written kernel in ``csrc/kd_traverse.cu`` (one thread a ray, its own
  stack) and raises if the launch fails or the tree or dtype is one it does
  not take; for CPU tensors it runs `kd_traverse_reference`. Nothing falls
  back from the card to the plain version.
- `kd_traverse_reference` is the plain PyTorch version: the reference's
  stack traversal in lockstep over rays, one (pop, test, push) step for all
  rays a loop iteration, until every stack is empty (a host read a step).
  The kernel and it agree bit for bit in t and ids.
- `kd_traverse.launches` counts kernel launches; inside a captured CUDA
  graph (`render_jit`, `make_train_step_jit`) that is the capture's launch,
  not the replays' (chip_smoke.py counts a replay's kernels in the
  profiler).

Operands: ``o`` (3,) the object-frame origin, ``d`` (R, 3) directions, of
one dtype, float32 or float64, which the tables' geometry (``p1``, ``e1``,
``e2``) shares; the kernel takes a tree of at most `max_stack` - 2 levels
(its stack has ``max_depth + 2`` entries). Returns (t (R,) in the rays'
dtype, ``draw_distance`` on a miss; tri (R,) int32 original triangle ids,
-1 on a miss).
"""

from __future__ import annotations

import ctypes

import torch

from ...utils.dtypes import DEFAULT_DRAW_DISTANCE, MT_EPSILON, SLAB_EPSILON
from .. import vecmath
from . import _build

_DTYPES = (torch.float32, torch.float64)
_fn = []


def _lib():
    if not _fn:
        lib = _build.load("kd_traverse")
        lib.kd_traverse_max_stack.argtypes = []
        lib.kd_traverse_max_stack.restype = ctypes.c_int
        lib.kd_traverse_launch.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 6
            + [ctypes.c_int] * 2 + [ctypes.c_double] * 3
            + [ctypes.c_void_p] * 3)
        lib.kd_traverse_launch.restype = ctypes.c_int
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
            ("p1", (n_tris, 3), d.dtype), ("e1", (n_tris, 3), d.dtype),
            ("e2", (n_tris, 3), d.dtype), ("perm", (n_tris,), torch.int32)):
        x = getattr(tables, name)
        if x.shape != shape or x.dtype != dtype:
            raise ValueError(f"{name} must be {shape} {dtype}, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if x.device != d.device or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {d.device}")


def kd_traverse(o: torch.Tensor, d: torch.Tensor, tables,
                draw_distance: float = DEFAULT_DRAW_DISTANCE,
                eps: float = MT_EPSILON, ray_chunk: int = 32768):
    """(t, tri) of the nearest hit of each ray ``o + t d`` over ``tables``
    (a `KDTables`). ``ray_chunk`` bounds the plain version's per-ray state
    (0: all rays at once) and changes no result; the kernel ignores it."""
    _check(o, d, tables)
    dev = d.device
    if dev.type == "cpu":
        return kd_traverse_reference(o, d, tables, draw_distance, eps,
                                     ray_chunk)
    if dev.type != "cuda":
        raise ValueError(f"no kd_traverse kernel for {dev}")
    depth = tables.max_depth + 2
    if depth > max_stack():
        raise ValueError(f"a KD tree of depth {tables.max_depth} needs a "
                         f"stack of {depth}; the kernel holds {max_stack()}")
    num_r = d.shape[0]
    t = torch.empty((num_r,), dtype=d.dtype, device=dev)
    tri = torch.empty((num_r,), dtype=torch.int32, device=dev)
    if num_r == 0:
        return t, tri
    o, d = o.contiguous(), d.contiguous()
    err = _lib().kd_traverse_launch(
        o.data_ptr(), d.data_ptr(), num_r, tables.node_box.data_ptr(),
        tables.node_link.data_ptr(), tables.p1.data_ptr(),
        tables.e1.data_ptr(), tables.e2.data_ptr(), tables.perm.data_ptr(),
        depth, int(d.dtype == torch.float64), float(draw_distance),
        float(eps), float(SLAB_EPSILON), t.data_ptr(), tri.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"kd_traverse kernel launch failed: CUDA error "
                           f"{err}")
    kd_traverse.launches += 1
    return t, tri


kd_traverse.launches = 0


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
                          counts: dict | None = None):
    """Plain PyTorch version of `kd_traverse` (same contract): the
    reference's stack traversal, in lockstep over rays.

    Per step each ray with a non-empty stack pops a node and slab-tests it
    (Trixel.cu:76-95); at a leaf it intersects the leaf's triangles
    (Trixel.cu:98-145), the lowest slot winning at the leaf's minimum t and
    the best changing only on a strictly smaller t; at an internal node it
    pushes the children by the s1/s2 split-plane rule (Trixel.cu:146-169),
    the far one first. It runs until every stack is empty. Rays go in runs
    of ``ray_chunk`` (0: all at once), which bound the per-ray state; the
    runs change no result. With ``counts`` (a dict) it adds the work it did
    as 0-d device tensors: ``slab_tests``, the (ray, internal node) pops,
    and ``mt_pairs``, the (ray, leaf slot) pairs.
    """
    num_r = d.shape[0]
    if ray_chunk and num_r > ray_chunk:
        parts = [kd_traverse_reference(o, d[i:i + ray_chunk], tables,
                                       draw_distance, eps, 0, counts)
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
    if counts is not None:
        for k in ("slab_tests", "mt_pairs"):
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
        # leaf: MT over the leaf's (padded) triangle range, for the rays
        # that popped a leaf only
        lr = torch.nonzero(active & leaf).squeeze(1)
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

        expand = active & box_hit & ~leaf
        if counts is not None:
            counts["slab_tests"] += (active & ~leaf).sum()
            counts["mt_pairs"] += tables.leaf_count[ln].sum()
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
