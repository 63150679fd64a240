"""PyTorch/CUDA port of the differentiable ray tracer.

A second package beside ``cpp_cuda_raytracer_dev_tpu`` (the JAX reference),
with the same module paths. It renders primary-ray frames by the
``method="bin"`` path, by the cluster paths ("grid", "pallas", "pallas2",
over a `ClusterAccel`) and by the KD traversal ("kd", over `KDTables`),
takes training steps through them (``parallel/render_pjit.py``), and has
the apps ``apps/render_cli.py`` and ``apps/animate.py``. Its kernels are
CUDA C++ written for Hopper: the bin intersect with its telemetry switch
(``csrc/bin_intersect.cu``), the gather backward's segment sum
(``csrc/segment_sum.cu``), the cluster paths' tile intersects K4 and K5
(``csrc/tile_intersect.cu``) and the per-tile bin kernel K6
(``csrc/bin_tile_intersect.cu``). The package imports ``torch`` and never
JAX.
"""

from .accel.traverse import ClusterAccel, KDTables
from .models.camera import Camera, Projection
from .models.renderer import RenderOutput, render, render_differentiable
from .models.scene import PhongParams, Scene, SceneObject, Triangles
from .ops.intersect import FixedOriginCache, Hit, mt_brute, mt_fixed_origin
from .ops.quaternion import Pose
from .utils.config import RenderConfig

__all__ = [
    "Camera", "ClusterAccel", "FixedOriginCache", "Hit", "KDTables",
    "PhongParams", "Pose", "Projection",
    "RenderConfig", "RenderOutput", "Scene", "SceneObject", "Triangles",
    "mt_brute", "mt_fixed_origin", "render", "render_differentiable",
]
