"""PyTorch/CUDA port of the differentiable ray tracer.

A second package beside ``cpp_cuda_raytracer_dev_tpu`` (the JAX reference),
with the same module paths. It renders the ``method="bin"`` primary-ray
frame and takes training steps through it (``parallel/render_pjit.py``).
Its kernels are CUDA C++ written for Hopper: the bin intersect with its
telemetry switch (``csrc/bin_intersect.cu``) and the gather backward's
segment sum (``csrc/segment_sum.cu``). The package imports ``torch`` and
never JAX.
"""

from .models.camera import Camera, Projection
from .models.renderer import RenderOutput, render, render_differentiable
from .models.scene import PhongParams, Scene, SceneObject, Triangles
from .ops.intersect import FixedOriginCache, Hit, mt_brute, mt_fixed_origin
from .ops.quaternion import Pose
from .utils.config import RenderConfig

__all__ = [
    "Camera", "FixedOriginCache", "Hit", "PhongParams", "Pose", "Projection",
    "RenderConfig", "RenderOutput", "Scene", "SceneObject", "Triangles",
    "mt_brute", "mt_fixed_origin", "render", "render_differentiable",
]
