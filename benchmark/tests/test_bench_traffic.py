"""The traffic generators repeat from their seeds and keep to their mixes:
the viewer's key script as the reference viewer (and the port) replays it,
and the fits' true leaves."""

import numpy as np
import pytest
import torch

from conftest import small_cell

SEEDS = (0, 7, 2**31 + 5)


def kind(name):
    from benchmark.harness import plugins
    return plugins.load("kinds", name)


def orbit_cycle(cell="bin.orbit"):
    from benchmark.harness import cells, scene
    c = cells.load(cell)
    return c, kind("serve").cycle(c.traffic, c.config, scene.vertices(c.config))


@pytest.mark.parametrize("seed", SEEDS)
def test_orbit_start_repeats_from_its_seed(seed):
    serve = kind("serve")
    assert serve.start_tick(seed, 170) == serve.start_tick(seed, 170)
    starts = {serve.start_tick(seed + k, 170) for k in range(20)}
    assert len(starts) >= 10


def test_orbit_cycle_follows_the_viewers_keys():
    c, poses = orbit_cycle()
    mix = c.traffic
    assert len(poses) == sum(t for _, t in mix["script"]) == 170
    q, t = poses[:, :4].astype(np.float64), poses[:, 4:].astype(np.float64)
    # the script closes: its last tick brings the pose back to the identity
    assert np.allclose(q[-1], [0, 0, 0, 1], atol=1e-6)
    assert np.allclose(t[-1], 0.0, atol=1e-6)
    keys = [k for k, n in mix["script"] for _ in range(n)]
    # a yaw tick turns the quaternion by 2 asin(0.0995), about 11.4 degrees,
    # about +y; a move tick leaves it
    turn = np.degrees(2 * np.arccos(np.clip(np.abs(
        (q[1:] * q[:-1]).sum(1)), 0, 1)))
    for k, a in zip(keys[1:], turn):
        if k in "RT":
            assert abs(a - 11.42) < 0.01
            assert a > 0
        else:
            assert a < 1e-4
    assert np.allclose(q[:, [0, 2]], 0.0, atol=1e-7)
    # W moves the object 0.005 along the view axis (+z from the camera at
    # z = -3), Q along the right axis; a yaw keeps the centre where it is
    steps = np.diff(t, axis=0)
    for k, s_, qa in zip(keys[1:], steps, q[:-1]):
        if k == "W":
            assert np.allclose(s_, [0, 0, 0.005], atol=1e-6)
        elif k == "S":
            assert np.allclose(s_, [0, 0, -0.005], atol=1e-6)
    assert np.abs(t).max() < 0.2


def test_orbit_cycle_equals_the_ports_key_replay():
    """A second witness: the port's own replay of the viewer's keys
    (``models/animation.py``) visits the same poses."""
    from benchmark.harness import scene
    from cpp_cuda_raytracer_dev_torch import (Camera, PhongParams, Pose,
                                              Scene, SceneObject, Triangles)
    from cpp_cuda_raytracer_dev_torch.models import animation
    c = small_cell("bin.orbit")
    tv = scene.vertices(c.config)
    poses = kind("serve").cycle(c.traffic, c.config, tv)
    lv = scene.leaves(c.config, tv, torch.device("cpu"))
    tris = Triangles(*[lv[f"tris.{n}"] for n in scene.TRI_FIELDS],
                     lv["tris.color"])
    cam = Camera(*[lv[f"camera.{k}"] for k in scene.CAMERA_FIELDS],
                 res_w=64, res_h=36)
    sc = Scene([SceneObject(tris, Pose(lv["pose.quat"].clone(),
                                        lv["pose.translation"].clone()))],
               PhongParams(*[lv[f"phong.{k}"] for k in scene.PHONG_FIELDS]))
    script = [animation.KeyEvent(k, n) for k, n in c.traffic["script"]]
    assert c.traffic["cam_speed"] == animation.CAM_SPEED
    assert c.traffic["key_quat"][1] == animation.KEY_QUAT_SIN
    for tick, _, s in animation.run_script(sc, cam, script):
        pose = s.objects[0].pose
        got = torch.cat([pose.quat, pose.translation]).detach().numpy()
        assert np.allclose(got, poses[tick], atol=2e-6), tick


@pytest.mark.parametrize("cell", ["bin.fit-all", "kd.fit-pose"])
@pytest.mark.parametrize("seed", SEEDS)
def test_truth_repeats_from_its_seed(cell, seed):
    from benchmark.harness import scene
    generator = kind("train")
    c = small_cell(cell)
    tv = scene.vertices(c.config)
    lv = scene.leaves(c.config, tv, torch.device("cpu"))
    a = generator.truth(c.traffic, seed, lv)
    b = generator.truth(c.traffic, seed, lv)
    other = generator.truth(c.traffic, seed + 1, lv)
    for k in lv:
        assert torch.equal(a[k], b[k]), k
    moved = [k for k in lv if not torch.equal(a[k], lv[k])]
    assert moved and all(not torch.equal(a[k], other[k]) for k in moved)
    # only the groups the mix perturbs move; the quaternion stays a unit
    assert all(k.split(".")[0] in c.traffic["train"] for k in moved)
    assert abs(float(a["pose.quat"].norm()) - 1.0) < 1e-6
    assert set(generator.trained(c.traffic, lv)) >= set(moved)
