"""Device milliseconds a served frame in kernel K7, the KD traversal."""

from benchmark.harness import kernels


def read(trace):
    ops = trace.named(kernels.K7)
    if trace.kind != "serve" or not ops:
        return None
    return kernels.seconds(ops) * 1e3 / trace.units
