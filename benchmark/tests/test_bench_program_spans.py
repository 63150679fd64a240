"""The readers of the program's own spans and set-up tallies on hand-made
traces: their sums a frame or step, the nested spans counted only inside
the entry span, the idle share inside the entry spans against the whole
idle share, and silence where a span or tally is absent or the trace is
of the other kind."""

import pytest

from benchmark.harness.trace import Trace, reader

SHAPES = {"rays": 518400, "triangles": 800130}
CARD = "NVIDIA H100 80GB HBM3"


def read(name, tr):
    return reader(name)(tr)


def serve_trace(spans=True):
    # two frames of 100 us; device work 0-10 (pose), 30-40 (the graph),
    # 60-70 (image); the entry span 20-50 holds the launch 25-28 and the
    # live read 41-48; a launch and a live read at 80-84 lie outside it
    dev, host = [], []
    for b in (0.0, 100.0):
        dev += [("Memcpy HtoD (Pinned -> Device)", b, b + 10),
                ("own_walk_kernel", b + 30, b + 40),
                ("Memcpy DtoH (Device -> Pinned)", b + 60, b + 70)]
        host += [("bench.unit", b, b + 100), ("cudaGraphLaunch", b + 26,
                                              b + 27)]
        if spans:
            host += [("rt.render_jit", b + 20, b + 50),
                     ("rt.graphs.launch", b + 25, b + 28),
                     ("rt.graphs.live", b + 41, b + 48),
                     ("rt.graphs.launch", b + 80, b + 82),
                     ("rt.graphs.live", b + 82, b + 84)]
    return Trace("serve", 2, (0.0, 200.0), dev, host, SHAPES, CARD)


def train_trace(spans=True):
    # two steps of 1000 us; device work 0-200 and 300-700; the entry span
    # 100-800 holds a launch 150-160
    dev, host = [], []
    for b in (0.0, 1000.0):
        dev += [("kd_traverse_kernel", b, b + 200),
                ("segment_sum_level<2>", b + 300, b + 700)]
        host.append(("bench.unit", b, b + 1000))
        if spans:
            host += [("rt.train_step", b + 100, b + 800),
                     ("rt.graphs.launch", b + 150, b + 160)]
    return Trace("train", 2, (0.0, 2000.0), dev, host, SHAPES, CARD)


def test_serve_span_readers_sum_a_frame():
    tr = serve_trace()
    assert read("entry_host_ms.serve", tr) == pytest.approx(30e-3)
    assert read("launch_ms", tr) == pytest.approx(3e-3)
    assert read("live_wait_ms", tr) == pytest.approx(7e-3)


def test_train_span_readers_sum_a_step():
    tr = train_trace()
    assert read("entry_host_ms.train", tr) == pytest.approx(700e-3)
    # idle 200-300 and 700-800 of each step lie inside its entry span
    assert read("idle_in_program_pct.train", tr) == pytest.approx(20.0)
    assert read("device_idle_pct.train", tr) == pytest.approx(40.0)


def test_nested_spans_count_only_inside_the_entry_span():
    tr = serve_trace()
    tr.host = [h for h in tr.host if h[0] != "rt.render_jit"]
    assert read("launch_ms", tr) is None
    assert read("live_wait_ms", tr) is None


def test_idle_inside_the_entry_span_is_part_of_the_idle_share():
    tr = serve_trace()
    # gap 10-30 is half inside the entry span 20-50 (10 us), gap 40-60
    # half (10 us); gap 70-100 lies outside: 2 x 20 us of 200
    inside = read("idle_in_program_pct.serve", tr)
    assert inside == pytest.approx(20.0)
    assert read("device_idle_pct.serve", tr) == pytest.approx(70.0)
    assert inside <= read("device_idle_pct.serve", tr)


def test_a_gap_half_in_an_entry_span_counts_by_half():
    tr = Trace("serve", 1, (0.0, 100.0),
               [("k", 0.0, 10.0), ("k", 30.0, 100.0)],
               [("rt.render_jit", 20.0, 60.0)], SHAPES, CARD)
    assert read("idle_in_program_pct.serve", tr) == pytest.approx(10.0)
    assert read("device_idle_pct.serve", tr) == pytest.approx(20.0)


SERVE_SPANS = ("entry_host_ms.serve", "launch_ms", "live_wait_ms",
               "idle_in_program_pct.serve")
TRAIN_SPANS = ("entry_host_ms.train", "idle_in_program_pct.train")


@pytest.mark.parametrize("name", SERVE_SPANS + TRAIN_SPANS)
def test_span_readers_are_silent_without_spans(name):
    assert read(name, serve_trace(spans=False)) is None
    assert read(name, train_trace(spans=False)) is None


@pytest.mark.parametrize("name,other",
                         [(n, train_trace) for n in SERVE_SPANS]
                         + [(n, serve_trace) for n in TRAIN_SPANS],
                         ids=SERVE_SPANS + TRAIN_SPANS)
def test_span_readers_are_silent_on_the_other_kind(name, other):
    assert read(name, other()) is None


@pytest.mark.parametrize("name", ("capture_s", "kd_build_s"))
def test_setup_tallies(name, monkeypatch):
    from cpp_cuda_raytracer_dev_torch.utils import profiling
    monkeypatch.setitem(profiling.SETUP_S, name, 0.75)
    assert read(name, serve_trace()) == 0.75
    assert read(name, train_trace()) == 0.75
    monkeypatch.setitem(profiling.SETUP_S, name, 0.0)
    assert read(name, serve_trace()) is None
    monkeypatch.delattr(profiling, "SETUP_S")     # a program without them
    assert read(name, serve_trace()) is None
