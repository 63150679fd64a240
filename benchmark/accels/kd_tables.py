"""The program's KD tables (``KDTables``, the tree kernel K7 walks), built
by its native builder at the configuration's leaf size."""

from __future__ import annotations


def build(params: dict, tv, tris) -> tuple:
    """``params``: ``leaf``, the most triangles a leaf holds; ``tv`` the
    (T, 3, 3) vertices; ``tris`` the program's `Triangles` over them."""
    from cpp_cuda_raytracer_dev_torch import KDTables
    from cpp_cuda_raytracer_dev_torch.accel.native import build_kd_fast
    tree = build_kd_fast(tv.min(axis=1), tv.max(axis=1), params["leaf"])
    return (KDTables.from_tree(tree, tris),)
