"""Device milliseconds a served frame in kernel K1, the bin intersect."""

from benchmark.harness import kernels


def read(trace):
    ops = trace.named(kernels.K1)
    if trace.kind != "serve" or not ops:
        return None
    return kernels.seconds(ops) * 1e3 / trace.units
