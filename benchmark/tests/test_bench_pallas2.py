"""The cluster-path configuration ``dragon800k-pallas2`` and the near
viewer's mix ``orbit-near``: the configuration loads and its accel builds,
its seconds counted where ``kd_build_s`` reads them;
the mix walks the object from 3.0 to 1.5 from the camera and back; the
readers of ``k4_ms``, ``cull_ms``, ``escalate_fill_pct`` and
``regrowths`` on hand-made traces, and their silence where the frame runs
no K4 or the program keeps no such counter or span; a small traced run of
``bin.orbit-near`` on the CPU."""

import json

import numpy as np
import pytest

from conftest import ROOT, small_cell
from benchmark.harness.trace import Trace, reader

SHAPES = {"rays": 518400, "triangles": 800130}
CARD = "NVIDIA H100 80GB HBM3"


def read(name, tr):
    return reader(name)(tr)


def test_pallas2_configuration_loads_and_builds_its_accel():
    import torch
    from benchmark.harness import cells, plugins, scene
    from cpp_cuda_raytracer_dev_torch import ClusterAccel, RenderConfig
    cell = cells.load("pallas2.orbit")
    cfg, bin_cfg = cell.config, cells.load("bin.orbit").config
    for k in ("mesh", "camera", "color", "phong", "precision"):
        assert cfg[k] == bin_cfg[k], k
    rc = RenderConfig(**cfg["render"])
    assert (rc.method, rc.escalate_all, rc.leaf_size) == ("pallas2", True,
                                                          128)
    assert cfg["kernel_sources"] == ["tile_intersect", "shade"]
    entry = next(c for c in json.loads(
        (ROOT / "BENCHMARK.json").read_text())["configs"]
        if c["name"] == "dragon800k-pallas2")
    assert "README.md:19" in entry["source"]
    assert "bench.py --method pallas2" in entry["source"]
    cut = small_cell("pallas2.orbit")
    tv = scene.vertices(cut.config)
    lv = scene.leaves(cut.config, tv, torch.device("cpu"))
    tris = scene.build_program(cut.config, lv, tv).scene.objects[0].tris
    from cpp_cuda_raytracer_dev_torch.utils.profiling import SETUP_S
    before = SETUP_S.get("kd_build_s", 0.0)
    (accel,) = plugins.load("accels", "cluster_accel").build(
        cfg["accel"], tv, tris)
    assert isinstance(accel, ClusterAccel) and accel.leaf_size == 128
    # the build's host seconds are what kd_build_s reads on this cell
    assert read("kd_build_s", None) > before
    assert sorted(accel.slot_tri[accel.slot_tri >= 0].tolist()) == \
        list(range(tv.shape[0]))


def test_orbit_near_walks_to_half_the_distance_and_back():
    from benchmark.harness import cells, plugins, scene
    cell = cells.load("bin.orbit-near")
    cut = small_cell("bin.orbit-near")
    serve = plugins.load("kinds", cell.traffic["kind"])
    assert cell.traffic["script"] == [["S", 300], ["W", 300]]
    poses = serve.cycle(cell.traffic, cell.config,
                        scene.vertices(cut.config))
    assert len(poses) == 600
    n = serve.camera_axes(cell.config)["n"]
    cam = scene.camera_start(cell.config)
    # the object's origin, seen from the camera along the view axis
    dist = (poses[:, 4:].astype(np.float64) - cam) @ n
    assert abs(dist.min() - 1.5) <= 0.01 and int(dist.argmin()) == 299
    assert abs(dist[-1] - 3.0) <= 1e-6
    assert np.allclose(poses[:, :4], [0, 0, 0, 1])


def pallas2_trace():
    # two frames of 100 us: K11 0-1, the cull 2-10, K4's order 10-11 and
    # first pass 11-31, the escalation's cull 32-36, its pass 36-40, the
    # splice 41-42, K10 43-45, the image 50-55
    dev = []
    for b in (0.0, 100.0):
        dev += [("frame_setup_kernel<float>", b, b + 1),
                ("reduce_kernel", b + 2, b + 6),
                ("DeviceSegmentedRadixSortKernel", b + 6, b + 10),
                ("longest_first_kernel", b + 10, b + 11),
                ("tile_intersect_kernel<true, 4>", b + 11, b + 31),
                ("DeviceRadixSortOnesweepKernel", b + 32, b + 36),
                ("tile_intersect_kernel<true, 4>", b + 36, b + 40),
                ("index_put_kernel", b + 41, b + 42),
                ("shade_compose_kernel<float>", b + 43, b + 45),
                ("Memcpy DtoH (Device -> Pinned)", b + 50, b + 55)]
    host = [("bench.unit", 0.0, 100.0), ("bench.unit", 100.0, 200.0),
            ("rt.graphs.regrow", 120.0, 121.0),
            ("rt.graphs.regrow", 250.0, 251.0)]     # outside the window
    return Trace("serve", 2, (0.0, 200.0), dev, host, SHAPES, CARD)


def bin_trace():
    dev = [("frame_setup_kernel<float>", 0.0, 1.0),
           ("tri_pass_kernel", 2.0, 10.0),
           ("longest_first_kernel", 11.0, 12.0),
           ("own_walk_kernel", 12.0, 30.0),
           ("shade_compose_kernel<float>", 31.0, 33.0)]
    return Trace("serve", 1, (0.0, 100.0), dev,
                 [("bench.unit", 0.0, 100.0)], SHAPES, CARD)


def test_k4_and_cull_readers():
    tr = pallas2_trace()
    assert read("k4_ms", tr) == pytest.approx((1 + 20 + 4) * 1e-3)
    assert read("cull_ms", tr) == pytest.approx((4 + 4 + 4) * 1e-3)


@pytest.mark.parametrize("name", ["k4_ms", "cull_ms"])
def test_k4_and_cull_readers_are_silent_without_k4(name):
    assert read(name, bin_trace()) is None
    tr = pallas2_trace()
    assert read(name, Trace("train", 2, tr.window, tr.device, tr.host,
                            SHAPES, CARD)) is None


def test_escalate_fill_reader(monkeypatch):
    from cpp_cuda_raytracer_dev_torch.utils import profiling
    tr = pallas2_trace()
    monkeypatch.setattr(profiling, "escalate_fill", lambda: ([48, 80], 128))
    assert read("escalate_fill_pct", tr) == pytest.approx(100 * 64 / 128)
    monkeypatch.setattr(profiling, "escalate_fill", lambda: None)
    assert read("escalate_fill_pct", tr) is None
    monkeypatch.delattr(profiling, "escalate_fill")
    assert read("escalate_fill_pct", tr) is None


def test_regrowths_reader_counts_the_spans_in_the_window(monkeypatch):
    from cpp_cuda_raytracer_dev_torch.utils import graphs
    assert read("regrowths", pallas2_trace()) == 1.0
    assert read("regrowths", bin_trace()) == 0.0
    monkeypatch.delattr(graphs, "REGROW_SPAN")
    assert read("regrowths", pallas2_trace()) is None


def test_near_cell_runs_small_on_the_cpu():
    from benchmark import run
    cell = small_cell("bin.orbit-near")
    cell.traffic["script"] = [["S", 4], ["W", 4]]
    out = run.run_cell(cell, 2**31 + 23, 0.3, True, "cpu")
    assert out["correct"] and out["failed"] == 0
    metrics = out["metrics"]
    assert metrics["regrowths"]["value"] == 0.0
    assert 0 < metrics["bin_fill_pct"]["value"] <= 100
    assert "k4_ms" not in metrics and "escalate_fill_pct" not in metrics
