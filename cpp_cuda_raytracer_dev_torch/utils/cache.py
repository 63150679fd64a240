"""Disk cache for built KD trees, keyed by mesh hash (the JAX package's
``utils/cache.py``).

The host build is O(n log n) (about 2 s at 800k triangles), so
`ClusterAccel.build` can amortise it across runs: ``np.savez`` keyed by a
content hash of the triangle AABBs and the leaf size. The port's cache
lives in ``build/kd_cache/`` at the repository root (git-ignored, beside
the built kernels), not in the JAX package's directory.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path

import numpy as np

from ..accel.kd_build import KDTree, build_kd

DEFAULT_CACHE_DIR = str(Path(__file__).resolve().parents[2] / "build"
                        / "kd_cache")

_FIELDS = ("bounds_min", "bounds_max", "cut_code", "s1", "s2", "left",
           "right", "parent", "leaf_start", "leaf_count", "perm")


def mesh_key(aabb_min: np.ndarray, aabb_max: np.ndarray,
             min_node_size: int) -> str:
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(aabb_min, np.float32).tobytes())
    h.update(np.ascontiguousarray(aabb_max, np.float32).tobytes())
    h.update(str(min_node_size).encode())
    return h.hexdigest()[:24]


def save_tree(tree: KDTree, key: str, cache_dir: str | None = None) -> str:
    cache_dir = cache_dir or DEFAULT_CACHE_DIR
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"kd_{key}.npz")
    np.savez(path, min_node_size=np.int64(tree.min_node_size),
             **{f: getattr(tree, f) for f in _FIELDS})
    return path


def load_tree(key: str, cache_dir: str | None = None) -> KDTree | None:
    path = os.path.join(cache_dir or DEFAULT_CACHE_DIR, f"kd_{key}.npz")
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return KDTree(**{f: z[f] for f in _FIELDS},
                      min_node_size=int(z["min_node_size"]))


def build_kd_cached(aabb_min: np.ndarray, aabb_max: np.ndarray,
                    min_node_size: int = 1,
                    cache_dir: str | None = None) -> KDTree:
    """Cache-through KD build (the numpy `build_kd` on a miss); the cache
    directory defaults to `DEFAULT_CACHE_DIR`, read at the call."""
    key = mesh_key(aabb_min, aabb_max, min_node_size)
    tree = load_tree(key, cache_dir)
    if tree is None:
        tree = build_kd(aabb_min, aabb_max, min_node_size)
        save_tree(tree, key, cache_dir)
    return tree
