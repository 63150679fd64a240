"""The per-layer readers and the breakdown on a synthetic profile, and
kernel K2's byte count."""

import pytest

from benchmark.harness.trace import Trace, breakdown, reader
from benchmark.rooflines import k2


def serve_trace():
    # two frames of 100 us each; device work 0-10, 12-40 (K8 .. K9b, K1),
    # 50-60 (K10), then the same 100 us later
    ops = []
    for base in (0.0, 100.0):
        ops += [("tri_pass_kernel", base, base + 10),
                ("DeviceScanKernel", base + 12, base + 14),
                ("entry_keys_kernel", base + 14, base + 16),
                ("DeviceRadixSortOnesweepKernel", base + 16, base + 20),
                ("entry_table_kernel", base + 20, base + 22),
                ("ray_table_kernel", base + 22, base + 24),
                ("own_walk_kernel", base + 24, base + 40),
                ("shade_compose_kernel", base + 50, base + 60)]
    host = [("bench.unit", 0.0, 100.0), ("bench.unit", 100.0, 200.0)]
    for base in (0.0, 100.0):
        host += [("cudaGraphLaunch", base + 40, base + 50),
                 ("cudaStreamSynchronize", base + 60, base + 100)]
    return Trace("serve", 2, (0.0, 200.0), ops, host,
                 {"rays": 518400, "triangles": 800130},
                 "NVIDIA H100 80GB HBM3")


def read(name, tr):
    return reader(name)(tr)


def test_serve_readers():
    tr = serve_trace()
    assert tr.busy_us() == 2 * (10 + 28 + 10)
    assert read("device_idle_pct.serve", tr) == pytest.approx(52.0)
    assert read("device_idle_pct.train", tr) is None
    assert read("device_ops_per_frame", tr) == 8
    assert read("device_ops_per_step", tr) is None
    assert read("prepass_ms", tr) == pytest.approx((10 + 2 + 2 + 4 + 2 + 2)
                                                   * 1e-3)
    assert read("k1_ms", tr) == pytest.approx(16e-3)
    assert read("k7_ms", tr) is None
    assert read("k2_roofline_pct", tr) is None


def test_breakdown_names_gaps_by_host_event():
    b = breakdown(serve_trace())
    ops = dict(b["device_ops"])
    assert ops["own_walk_kernel"] == pytest.approx(32e-6)
    gaps = dict(b["idle_gaps"])
    # 40-50 under the graph launch, 60-100 under the sync, 10-12 under the
    # frame's span
    assert gaps["cudaGraphLaunch"] == pytest.approx(20e-6)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(80e-6)
    assert gaps["bench.unit"] == pytest.approx(4e-6)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def train_trace(kd=False):
    ops = []
    for base in (0.0, 1000.0):
        ops += [("vectorized_elementwise_kernel<FillFunctor<float>>", base,
                 base + 5)]
        if not kd:
            ops += [("vectorized_elementwise_kernel<FillFunctor<float>>",
                     base + 10, base + 20),
                    ("segment_sum_level<2>", base + 20, base + 40),
                    ("segment_sum_level<2>", base + 40, base + 41),
                    ("segment_sum_level<2>", base + 41, base + 42)]
        ops += [("kd_traverse_kernel" if kd else "own_walk_kernel",
                 base + 100, base + 300)]
    return Trace("train", 2, (0.0, 2000.0), ops, [],
                 {"rays": 518400, "triangles": 800130},
                 "NVIDIA H100 80GB HBM3")


def test_k2_roofline_counts_its_call_with_the_fill():
    tr = train_trace()
    least = k2.bytes_moved(518400, 800130) / 3.35e12   # seconds a step
    want = 100 * least / ((10 + 20 + 1 + 1) * 1e-6)
    assert read("k2_roofline_pct", tr) == pytest.approx(want)
    assert read("device_ops_per_step", tr) == 6
    assert read("device_idle_pct.train", tr) == pytest.approx(
        100 * (1 - 2 * (5 + 32 + 200) / 2000))
    assert read("k1_ms", tr) is None      # not a serving trace


def test_k2_reader_is_silent_without_k2():
    assert read("k2_roofline_pct", train_trace(kd=True)) is None


def test_k2_reader_is_silent_on_an_unknown_card():
    tr = train_trace()
    tr.device_kind = "some other card"
    assert read("k2_roofline_pct", tr) is None


def test_k2_bytes_at_the_headline():
    # 518,400 cotangent rows of 12 float32 features with an int32 id and an
    # int64 place in the sort order, 800,130 output rows of 12 float32
    assert k2.bytes_moved(518400, 800130) == 69_510_240
    assert k2.bytes_moved(1, 0, features=3) == 12 + 4 + 8
    assert k2.bytes_moved(0, 5) == 5 * 48


def test_gaps_cover_the_window_less_the_busy_time():
    tr = serve_trace()
    idle = sum(e - s for s, e in tr.gaps())
    assert idle == pytest.approx(tr.window_us - tr.busy_us())
