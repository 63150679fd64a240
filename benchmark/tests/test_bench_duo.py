"""The reference's two-object scene (``duo.orbit``: the configuration
``dragon800k-duo-bin``, the mix ``orbit-duo`` of the kind
``serve_objects``) and ``bin.fit-pose``: the mix's cycle, the plain
reference over posed objects, runs on the CPU at a cut size (sound runs
correct; a combine that keeps the farther hit, a stale frame, a frozen
state and the control not correct) and the readers of ``bin_fill_pct``
and ``combine_ms``."""

import time

import numpy as np
import pytest
import torch

from conftest import small_cell
from test_bench_imports import _python

# the cut script of `small_cell`'s serve cells: 12 ticks, closed
SCRIPT = [["W", 2], ["R", 2], ["Q", 1], ["T", 2], ["E", 1], ["S", 2],
          ["R", 1], ["T", 1]]


def duo_cell(**traffic):
    cell = small_cell("duo.orbit")
    cell.traffic.update(dict(dict(script=SCRIPT, check_frames=2), **traffic))
    return cell


def run(cell, seed=11, seconds=0.3):
    from benchmark import run as bench_run
    return bench_run.run_cell(cell, seed, seconds, False, "cpu",
                              t0=time.perf_counter())


def kind():
    from benchmark.harness import plugins
    return plugins.load("kinds", "serve_objects")


def test_orbit_duo_cycle_moves_object_0_only_and_closes():
    """The viewer's keys on object 0 from its start pose: each R/T tick
    turns it 11.4 degrees about +y with its centre where it was, each
    W/S/Q/E tick moves its centre 0.005 along the camera's view or right
    axis; object 1 stays; after the script's 170 ticks object 0 is back at
    its start pose."""
    from benchmark.harness import cells, plugins, scene
    serve = plugins.load("kinds", "serve")
    c = cells.load("duo.orbit")
    tv = scene.vertices(c.config)
    poses = kind().cycle(c.traffic, c.config, tv).astype(np.float64)
    start = kind().start_poses(c.config)
    assert poses.shape == (170, 2, 7)
    assert np.allclose(poses[:, 1], start[1], atol=1e-7)
    assert np.allclose(poses[-1, 0], start[0], atol=1e-6)
    assert not np.allclose(poses[:-1, 0], start[0], atol=1e-4)
    axes = serve.camera_axes(c.config)
    centre = (tv.min(axis=(0, 1)).astype(np.float64)
              + tv.max(axis=(0, 1)).astype(np.float64)) / 2
    keys = [k for k, n in c.traffic["script"] for _ in range(n)]
    prev = start[0]
    for key, pose in zip(keys, poses[:, 0]):
        q, t, pq, pt = pose[:4], pose[4:], prev[:4], prev[4:]
        moved = (serve._rotation(q) @ centre + t
                 - serve._rotation(pq) @ centre - pt)
        turn = np.degrees(2 * np.arccos(min(abs(float(q @ pq)), 1.0)))
        if key in "RT":
            assert abs(turn - 11.42) < 0.01 and np.allclose(moved, 0,
                                                            atol=2e-6)
            # about +y: the turn's axis is the y axis
            spin = serve._qmul(q, pq * [-1, -1, -1, 1])
            assert np.allclose(spin[[0, 2]], 0, atol=1e-6)
        else:
            sign = 1.0 if key in "WQ" else -1.0
            axis = axes["n"] if key in "WS" else axes["u"]
            assert np.allclose(q, pq, atol=1e-6)
            assert np.allclose(moved, sign * 0.005 * axis, atol=2e-6)
        prev = pose


def test_objects_reference_loads_nothing_of_the_program():
    src = """
import sys
sys.path.insert(0, {root!r})
import benchmark.reference.objects
print(sorted({{m.split(".")[0] for m in sys.modules}}
             & {{"cpp_cuda_raytracer_dev_torch", "cpp_cuda_raytracer_dev_tpu",
                "jax", "jaxlib", "flax"}}))
"""
    assert _python(src) == "[]"


def test_objects_reference_of_one_object_is_the_reference():
    """With one object the reference over posed objects is `render`'s."""
    from benchmark.harness import scene
    from benchmark.reference import objects, render
    c = small_cell("bin.orbit")
    tv = scene.vertices(c.config)
    lv = scene.leaves(c.config, tv, torch.device("cpu"))
    tris, pose, cam, phong = scene.reference_inputs(c.config, lv)
    q = torch.tensor([0.0, 0.2, 0.0, 0.98])
    pose = {"quat": q / q.norm(), "translation": torch.tensor([0.1, 0.0,
                                                              0.2])}
    a = render.render(tris, pose, cam, phong, True)
    b = objects.render_objects(tris, [pose], cam, phong, True)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert torch.equal(b["obj"], torch.where(a["tri"] >= 0, 0, -1))


def test_objects_reference_combines_the_nearest_hit():
    """Two objects: each pixel takes the nearer object's hit, the first
    object's on a tie; the frame of that choice is each object's own."""
    from benchmark.harness import scene
    from benchmark.reference import objects, render
    c = duo_cell()
    tv = scene.vertices(c.config)
    lv = scene.leaves(c.config, tv, torch.device("cpu"))
    poses = kind().start_poses(c.config)
    tris, pl, cam, phong = kind().reference_inputs(c.config, lv, poses)
    out = objects.render_objects(tris, pl, cam, phong, True)
    per = [render.render(tris, p, cam, phong, True) for p in pl]
    near1 = per[1]["t"] < per[0]["t"]
    assert torch.equal(out["obj"], torch.where(
        near1, 1, torch.where(per[0]["tri"] >= 0, 0, -1)))
    assert int((near1 & (per[0]["tri"] >= 0)).sum()) > 10
    for k in ("t", "tri", "radiance", "image", "margin", "cos"):
        want = torch.where(near1.reshape(-1, *[1] * (per[0][k].dim() - 1)),
                           per[1][k], per[0][k])
        assert torch.equal(out[k], want), k


def test_sound_duo_run_is_correct_and_reads_its_metrics():
    from benchmark import run as bench_run
    cell = duo_cell()
    out = bench_run.run_cell(cell, 2**31 + 13, 0.3, True, "cpu",
                             t0=time.perf_counter())
    assert out["correct"], out["checks"]
    fill = out["metrics"]["bin_fill_pct"]["value"]
    assert 0 < fill <= 100


@pytest.mark.parametrize("cell", ["duo.orbit", "bin.fit-pose"])
def test_sound_run_is_correct(cell):
    c = duo_cell() if cell == "duo.orbit" else small_cell(cell)
    out = run(c)
    assert out["correct"], out["checks"]


def farther_on_one_tile(monkeypatch, frame: int, res_w: int, rows: tuple,
                        cols: tuple, changed: list):
    """The combine keeps the farther of two hits on one 16x32 tile (rows
    ``rows``, columns ``cols`` of a ``res_w`` wide frame) of the frame
    ``frame`` (counting `render_jit`'s calls from 0); ``changed`` gets the
    pixels it altered."""
    import cpp_cuda_raytracer_dev_torch as port
    from cpp_cuda_raytracer_dev_torch.ops.intersect import Hit
    merge, render_jit = Hit.merge, port.render_jit
    calls = [0]

    def faulty(self, other):
        out = merge(self, other)
        if calls[0] - 1 != frame:
            return out
        i = torch.arange(self.t.shape[0], device=self.t.device)
        y, x = i // res_w, i % res_w
        tile = ((y >= rows[0]) & (y < rows[1]) & (x >= cols[0])
                & (x < cols[1]) & (self.tri >= 0) & (other.tri >= 0))
        take = torch.where(tile, other.t > self.t, other.t < self.t)
        changed.append(int((take != (other.t < self.t)).sum()))
        return Hit(t=torch.where(take, other.t, self.t),
                   tri=torch.where(take, other.tri, self.tri),
                   obj=torch.where(take, other.obj, self.obj))

    def counted(*args, **kw):
        calls[0] += 1
        return render_jit(*args, **kw)
    monkeypatch.setattr(Hit, "merge", faulty)
    monkeypatch.setattr(port, "render_jit", counted)


def test_farther_hit_on_one_tile_of_one_checked_frame_is_not_correct(
        monkeypatch):
    """Every window frame is checked here (``check_frames`` above the
    window's frames), and the fault is in the window's first frame only:
    the calls before it are the warm-up's whole cycle."""
    cell = duo_cell(check_frames=1000)
    changed: list = []
    farther_on_one_tile(monkeypatch, sum(n for _, n in SCRIPT),
                        cell.config["camera"]["res_w"], (16, 32), (0, 32),
                        changed)
    out = run(cell, seconds=0.2)
    assert changed and sum(changed) > 0
    assert out["correct"] is False, out["checks"]
    assert out["checks"]["pixel_off_share"]["value"] > 0


def stale(monkeypatch):
    """Every frame returns the first frame's output."""
    import cpp_cuda_raytracer_dev_torch as port
    render_jit, first = port.render_jit, []

    def fn(*args, **kw):
        out = render_jit(*args, **kw)
        if not first:
            first.append(out)
        return first[0]
    monkeypatch.setattr(port, "render_jit", fn)


def frozen_state(monkeypatch):
    """Every optimizer step leaves the parameters as they were."""
    monkeypatch.setattr(torch.optim.SGD, "step", lambda self, *a, **k: None)


@pytest.mark.parametrize("cell,fault", [("duo.orbit", stale),
                                        ("bin.fit-pose", frozen_state)],
                         ids=["duo.orbit-stale", "bin.fit-pose-frozen"])
def test_broken_run_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    c = duo_cell() if cell == "duo.orbit" else small_cell(cell)
    out = run(c)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("seed", [5, 2**31 + 7, 998877665])
def test_duo_control_is_not_correct_and_the_reference_is(seed):
    """The control (the reference in TF32 in the program's place) fails
    the check; the reference's own frame judged against itself passes it
    with nothing off."""
    from benchmark import run as bench_run
    from benchmark.harness import check, scene
    c = duo_cell()
    out = bench_run.run_cell(c, seed, 0.1, False, "cpu",
                             t0=time.perf_counter(), control=True)
    ok, judged = check.judge(out["control"], c.limits)
    assert not ok, judged
    tv = scene.vertices(c.config)
    lv = scene.leaves(c.config, tv, torch.device("cpu"))
    poses = kind().cycle(c.traffic, c.config, tv)[seed % 12]
    own = kind().reference_inputs(c.config, lv, poses)
    from benchmark.reference import objects
    frame = objects.render_objects(*own, True)
    num = kind().judge(c.config, lv, poses, frame)
    assert num["off"] == 0 and num["radiance_gap"] == 0
    assert num["objects"] == [0, 1]


def combine_trace():
    from benchmark.harness.trace import Trace
    ops = []
    for base in (0.0, 100.0):
        ops += [("frame_setup_kernel", base, base + 1)]
        for k in range(2):            # two objects
            b = base + 1 + 30 * k
            ops += [("FillFunctor<int>", b, b + 1),
                    ("tri_pass_kernel", b + 1, b + 5),
                    ("entry_table_kernel", b + 5, b + 8),
                    ("longest_first_kernel", b + 8, b + 9),
                    ("own_walk_kernel", b + 9, b + 20),
                    ("elementwise_kernel<copy>", b + 20, b + 22),
                    ("where_kernel", b + 22, b + 25)]
        ops += [("shade_compose_kernel", base + 70, base + 75),
                ("Memcpy DtoH", base + 75, base + 80)]
    return Trace("serve", 2, (0.0, 200.0), ops, [],
                 {"rays": 518400, "triangles": 1600260},
                 "NVIDIA H100 80GB HBM3")


def test_combine_reader_counts_after_each_k1_to_the_next_stage():
    from benchmark.harness.trace import reader
    tr = combine_trace()
    # each object's untile and merge (2 + 3 us), K8's counter fill left out
    assert reader("combine_ms")(tr) == pytest.approx(2 * 5e-3)
    tr.kind = "train"
    assert reader("combine_ms")(tr) is None
    tr.kind = "serve"
    tr.device = [ev for ev in tr.device if "own_walk" not in ev[0]]
    assert reader("combine_ms")(tr) is None


def test_bin_fill_reader_is_silent_without_the_counter(monkeypatch):
    from benchmark.harness.trace import reader
    from cpp_cuda_raytracer_dev_torch.utils import profiling
    tr = combine_trace()
    monkeypatch.setattr(profiling, "bin_fill", lambda: ([300, 500], 1024))
    assert reader("bin_fill_pct")(tr) == pytest.approx(100 * 400 / 1024)
    monkeypatch.setattr(profiling, "bin_fill", lambda: None)
    assert reader("bin_fill_pct")(tr) is None
    monkeypatch.delattr(profiling, "bin_fill")
    assert reader("bin_fill_pct")(tr) is None
