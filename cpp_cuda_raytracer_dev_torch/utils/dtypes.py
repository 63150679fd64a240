"""Scalar constants and the precision switch of the renderer (the JAX
package's ``utils/dtypes.py``).

`Precision` is the runtime analogue of the reference's compile-time
precision switch (``typedefs.h:11-29``: ``PPP_TAG`` selects ``T_fp`` =
float or double). Pass ``F64.fp`` as the ``dtype`` of
``Triangles.from_vertices``, ``Camera.create``, ``PhongParams.reference``
and ``Pose.identity``; the scene's dtype then flows through ray generation,
the ``brute`` and ``fixed`` intersects and the shading, gradients
included. The kernel methods (``bin``, ``grid``, ``pallas``, ``pallas2``)
and ``raster`` are float32 by construction and refuse float64
(``models/renderer.py`` `trace_rays`).
"""

from __future__ import annotations

import dataclasses

import torch

# Möller–Trumbore acceptance epsilon (reference vector.cuh:10-13); 1e-16 is
# representable in float32, so the same literal serves both precisions.
MT_EPSILON = 1e-16

# Slab-test epsilon of the KD traversal (reference Trixel.cu:146-163).
SLAB_EPSILON = 1e-16

# Ray termination distance (reference Camera.cpp:70, Trixel.cu:47).
DEFAULT_DRAW_DISTANCE = 400.0

# Miss-pixel fill colour (reference Camera.cpp:72).
DEFAULT_BACKGROUND_RGB = (240, 130, 0)


@dataclasses.dataclass(frozen=True)
class Precision:
    """Bundle of dtypes, the analogue of typedefs.h's T_fp / T_uint /
    T_int."""

    fp: torch.dtype = torch.float32
    int_: torch.dtype = torch.int32
    uint: torch.dtype = torch.uint32

    @property
    def precision_shift(self) -> int:
        """Sign-bit shift for this float width (typedefs.h:14-29)."""
        return 31 if self.fp == torch.float32 else 63


F32 = Precision()
F64 = Precision(fp=torch.float64, int_=torch.int64, uint=torch.uint64)
