"""Scalar constants of the renderer (the JAX package's ``utils/dtypes.py``).

The port runs in float32 only; the float64 paths are a later item of the
ROADMAP (queue 1, item 11).
"""

# Möller–Trumbore acceptance epsilon (reference vector.cuh:10-13).
MT_EPSILON = 1e-16

# Slab-test epsilon of the KD traversal (reference Trixel.cu:146-163).
SLAB_EPSILON = 1e-16

# Ray termination distance (reference Camera.cpp:70, Trixel.cu:47).
DEFAULT_DRAW_DISTANCE = 400.0

# Miss-pixel fill colour (reference Camera.cpp:72).
DEFAULT_BACKGROUND_RGB = (240, 130, 0)
