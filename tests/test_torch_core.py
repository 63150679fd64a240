"""PyTorch port vs the JAX package: procgen, config, pose, camera, the
parameter converter, and the port's independence from JAX.

Inputs are made with numpy from a seed and fed to both packages. Float
tolerance: rtol 1e-6, plus atol 1e-6 on O(1) values that come out of a
cancellation (1 - 2y² - 2z²): XLA on the CPU contracts a·b + c·d into
fused multiply-adds and PyTorch does not, which moves such values by a
few float32 ulps.
"""

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpp_cuda_raytracer_dev_tpu as J
from cpp_cuda_raytracer_dev_tpu.ops import quaternion as jq
from cpp_cuda_raytracer_dev_tpu.utils import procgen as jprocgen
from cpp_cuda_raytracer_dev_torch import Camera, Pose, RenderConfig
from cpp_cuda_raytracer_dev_torch.ops import quaternion as pq
from cpp_cuda_raytracer_dev_torch.utils import procgen as pprocgen
from cpp_cuda_raytracer_dev_torch.utils.convert import (camera_from_numpy,
                                                        path_dict,
                                                        scene_from_numpy)

RTOL = 1e-6


@pytest.mark.parametrize("name,args", [
    ("uv_sphere", (12, 12)),
    ("uv_sphere", (50, 50, 1.0, 0.03, 3)),
    ("dragon_class_mesh", (20_000,)),
    ("clustered_mesh", (20_000, 1)),
])
def test_procgen_byte_identical(name, args):
    a = getattr(jprocgen, name)(*args)
    b = getattr(pprocgen, name)(*args)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def test_render_config_translates_one_to_one():
    fj = [(f.name, f.default) for f in dataclasses.fields(J.RenderConfig)]
    fp = [(f.name, f.default) for f in dataclasses.fields(RenderConfig)]
    assert fj == fp
    for method in ("brute", "fixed", "bin", "grid", "pallas", "pallas2",
                   "kd"):
        RenderConfig(method=method)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        RenderConfig(method="raster")
    # the cluster paths run float32 MT only, and count sub-tiles (debug
    # mode 1) but not the TPU floor probes
    RenderConfig(method="pallas2", debug_mode=1, with_stats=True)
    for kw in (dict(mt_precision="high"), dict(mt_precision="default"),
               dict(debug_mode=2), dict(debug_mode=3)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            RenderConfig(method="pallas2", **kw)
    # the bin kernel's telemetry switch (K3) is ported; its bf16 preview
    # mode is not
    RenderConfig(method="bin", with_stats=True, bin_esub=4)
    with pytest.raises(NotImplementedError, match="K1"):
        RenderConfig(method="bin", bin_mt_dtype="bfloat16")
    with pytest.raises(ValueError):
        RenderConfig(method="nope")


def _random_pose(rng):
    axis = rng.standard_normal(3).astype(np.float32)
    angle = float(rng.uniform(-np.pi, np.pi))
    trans = rng.standard_normal(3).astype(np.float32)
    jpose = jq.Pose(quat=jq.from_axis_angle(jnp.asarray(axis), angle),
                    translation=jnp.asarray(trans))
    ppose = Pose(pq.from_axis_angle(axis, angle, device="cpu"),
                 torch.tensor(trans))
    return jpose, ppose


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pose_matches_jax(seed):
    rng = np.random.default_rng(seed)
    jpose, ppose = _random_pose(rng)
    pts = rng.standard_normal((64, 3)).astype(np.float32)
    np.testing.assert_allclose(ppose.quat.detach().numpy(),
                               np.asarray(jpose.quat), rtol=RTOL, atol=1e-7)
    with torch.no_grad():
        for fn in ("apply", "inv_apply", "inv_apply_vec"):
            np.testing.assert_allclose(
                getattr(ppose, fn)(torch.tensor(pts)).numpy(),
                np.asarray(getattr(jpose, fn)(jnp.asarray(pts))),
                rtol=RTOL, atol=1e-6)
        np.testing.assert_allclose(ppose.matrix().numpy(),
                                   np.asarray(jpose.matrix()),
                                   rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("res,pos", [
    ((96, 64), (0.0, 0.2, -3.0)),
    ((33, 17), (0.7, -0.4, 2.5)),
])
def test_camera_matches_jax(res, pos):
    kw = dict(pos=pos, look_at=[0.1, 0.0, -0.2], up=[0.0, 1.0, 0.0],
              film_h=0.024, focal=0.055)
    jcam = J.Camera.create(*res, **kw)
    pcam = Camera.create(*res, **kw, device="cpu")
    np.testing.assert_allclose(pcam.ray_directions().numpy(),
                               np.asarray(jcam.ray_directions()),
                               rtol=RTOL, atol=1e-7)
    jproj, pproj = jcam.projection(), pcam.projection()
    rng = np.random.default_rng(7)
    jpose, ppose = _random_pose(rng)
    with torch.no_grad():
        for jp, pp in ((jproj, pproj),
                       (jproj.transformed(jpose), pproj.transformed(ppose))):
            for f in ("origin", "n", "u", "v", "sx", "sy", "adjust_x",
                      "adjust_y"):
                np.testing.assert_allclose(getattr(pp, f).numpy(),
                                           np.asarray(getattr(jp, f)),
                                           rtol=RTOL, atol=1e-7, err_msg=f)


def test_converter_round_trip():
    rng = np.random.default_rng(3)
    jpose, _ = _random_pose(rng)
    tv = rng.standard_normal((40, 3, 3)).astype(np.float32)
    color = rng.uniform(size=(40, 3)).astype(np.float32)
    jscene = J.Scene.create([
        J.SceneObject.create(J.Triangles.from_vertices(tv, color), jpose),
        J.SceneObject.create(J.Triangles.from_vertices(tv[:7]))])
    d = path_dict(jax.tree_util.tree_flatten_with_path(jscene)[0])
    scene = scene_from_numpy(d, "cpu")
    back = {k: v.detach().numpy() for k, v in scene.state_dict().items()}
    assert back.keys() == d.keys()
    for k in d:
        assert back[k].dtype == d[k].dtype
        np.testing.assert_array_equal(back[k], d[k], err_msg=k)

    jcam = J.Camera.create(40, 30, pos=[0.1, 0.2, -2.0], look_at=[0, 0, 0],
                           up=[0, 1, 0])
    cd = path_dict(jax.tree_util.tree_flatten_with_path(jcam)[0])
    cam = camera_from_numpy({**cd, "res_w": 40, "res_h": 30}, "cpu")
    assert (cam.res_w, cam.res_h) == (40, 30)
    for k, v in cd.items():
        np.testing.assert_array_equal(getattr(cam, k).numpy(), v)
    np.testing.assert_allclose(cam.ray_directions().numpy(),
                               np.asarray(jcam.ray_directions()),
                               rtol=RTOL, atol=1e-7)


def test_port_never_imports_jax():
    code = ("import sys, cpp_cuda_raytracer_dev_torch, "
            "cpp_cuda_raytracer_dev_torch.accel.traverse, "
            "cpp_cuda_raytracer_dev_torch.utils.convert; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'cpp_cuda_raytracer_dev_tpu'))]; "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
