"""The reader of `setup_train_ms` on a synthetic profile."""

import pytest

from benchmark.harness.trace import Trace, reader


def _trace(kind, names):
    ops = []
    for base in (0.0, 1000.0):
        ops += [(name, base + 100 * i, base + 100 * i + 20 + i)
                for i, name in enumerate(names)]
    return Trace(kind, 2, (0.0, 2000.0), ops, [],
                 {"rays": 518400, "triangles": 800130},
                 "NVIDIA H100 80GB HBM3")


def test_reads_k11_and_both_k13_kernels_a_step():
    tr = _trace("train", [
        "void (anonymous namespace)::frame_setup_kernel<float>(int, ...)",
        "own_walk_kernel",
        "void (anonymous namespace)::frame_setup_grad_kernel<float>(int, "
        "...)", "reduce_kernel",
        "void (anonymous namespace)::frame_setup_grad_chain_kernel<float>("
        "int, ...)"])
    assert reader("setup_train_ms")(tr) == pytest.approx((20 + 22 + 24)
                                                         * 1e-3)


@pytest.mark.parametrize("kind,names", [
    ("train", ["frame_setup_kernel", "shade_grad_kernel", "reduce_kernel"]),
    ("serve", ["frame_setup_kernel", "frame_setup_grad_kernel"])])
def test_silent_without_k13_or_on_a_frame(kind, names):
    assert reader("setup_train_ms")(_trace(kind, names)) is None
