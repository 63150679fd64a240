"""The benchmark's frozen mesh is the port's headline mesh, byte for byte
(the yardstick keeps it when the program's generator changes)."""

import numpy as np


def test_frozen_mesh_equals_the_ports_dragon_class_mesh():
    from benchmark.harness import plugins
    from cpp_cuda_raytracer_dev_torch.utils import procgen
    mesh = plugins.load("meshes", "dragon_class_mesh")
    a = mesh.vertices({"triangles": 800_000, "seed": 0})
    b = procgen.dragon_class_mesh(800_000)
    assert a.shape == (800_130, 3, 3) and a.dtype == np.float32
    assert a.tobytes() == b.tobytes()
