"""The reader of `shade_train_ms` on a synthetic profile."""

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


def test_reads_both_kernels_a_step():
    tr = _trace("train", ["own_walk_kernel",
                          "void (anonymous namespace)::shade_compose_kernel"
                          "<float>(int, ...)", "reduce_kernel",
                          "void (anonymous namespace)::shade_grad_kernel"
                          "<float, 1>(int, ...)"])
    assert reader("shade_train_ms")(tr) == pytest.approx((21 + 23) * 1e-3)


@pytest.mark.parametrize("kind,names", [
    ("train", ["own_walk_kernel", "elementwise_kernel"]),
    ("serve", ["shade_compose_kernel"])])
def test_silent_without_the_kernels_or_on_a_frame(kind, names):
    assert reader("shade_train_ms")(_trace(kind, names)) is None
