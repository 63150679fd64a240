"""PyTorch/CUDA port of the differentiable ray tracer.

A second package beside ``cpp_cuda_raytracer_dev_tpu`` (the JAX reference),
with the same module paths and everything the JAX package does: it renders
primary-ray frames by the ``method="bin"`` path, by the cluster paths
("grid", "pallas", "pallas2", over a `ClusterAccel`, built by the native KD
builder ``accel/native.py``), by the KD traversal ("kd", over `KDTables`),
by scatter-min rasterization ("raster", ``accel/raster.py``) and by the
oracles ("brute", "fixed"; these two and "kd" also run in float64,
``utils/dtypes.py``); takes training steps through them; shards frames and
steps over a ``torch.distributed`` mesh (``parallel/``); and has the apps
``apps/render_cli.py`` and ``apps/animate.py``. Its kernels are CUDA C++
written for Hopper: the bin intersect with its telemetry switch
(``csrc/bin_intersect.cu``), the gather backward's segment sum
(``csrc/segment_sum.cu``), the cluster paths' tile intersects K4 and K5
(``csrc/tile_intersect.cu``), the per-tile bin kernel K6
(``csrc/bin_tile_intersect.cu``) and the KD traversal K7
(``csrc/kd_traverse.cu``). `render_jit` and
``parallel/render_pjit.py`` `make_train_step_jit` replay the frame and the
step as captured CUDA graphs (``utils/graphs.py``), and with a mesh
`render_sharded_jit` and `make_train_step_jit` replay each rank's sharded
frame and step, collectives included. The package imports
``torch`` and never JAX.
"""

from .accel.traverse import ClusterAccel, KDTables
from .io.ply import MeshData, load_mesh, read_ply
from .models.camera import Camera, Projection, RayBuffers
from .models.renderer import (RenderOutput, render, render_differentiable,
                              render_jit)
from .models.scene import (PhongParams, Scene, SceneObject, Triangles,
                           default_colors)
from .ops.intersect import FixedOriginCache, Hit, mt_brute, mt_fixed_origin
from .ops.quaternion import Pose
from .utils.config import RenderConfig

__all__ = [
    "Camera", "ClusterAccel", "FixedOriginCache", "Hit", "KDTables",
    "MeshData", "PhongParams", "Pose", "Projection", "RayBuffers",
    "RenderConfig", "RenderOutput", "Scene", "SceneObject", "Triangles",
    "default_colors", "load_mesh", "mt_brute", "mt_fixed_origin",
    "read_ply", "render", "render_differentiable", "render_jit",
]
