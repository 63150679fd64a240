"""The program's cluster accel (``ClusterAccel``, the candidate clusters
kernel K4 walks), built by its KD build at the configuration's leaf
size, anew each run (no disk cache)."""

from __future__ import annotations


def build(params: dict, tv, tris) -> tuple:
    """``params``: ``leaf``, the most triangles a cluster holds; ``tv`` the
    (T, 3, 3) vertices (unused: the build reads ``tris``); ``tris`` the
    program's `Triangles` over them."""
    from cpp_cuda_raytracer_dev_torch import ClusterAccel
    return (ClusterAccel.build(tris, leaf_size=params["leaf"], cache=False),)
