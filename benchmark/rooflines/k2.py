"""Kernel K2's bytes from its contract (the segment sum that is the
backward of the shading's row gather, ``ops/cuda/segment_sum.py``):
every cotangent row (F float32 features) is read once with its sorted id
(int32) and its place in the sort order (int64), and every row of the
(T, F) output is written once."""


def bytes_moved(rays: int, triangles: int, features: int = 12) -> int:
    return rays * (features * 4 + 4 + 8) + triangles * features * 4
