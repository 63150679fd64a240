"""Device milliseconds a served frame in the binning prepass: kernel K8's
triangle pass and ray table, the cumsum, K9's keys, the sort and K9's
table (`harness/kernels.py` `prepass`)."""

from benchmark.harness import kernels


def read(trace):
    if trace.kind != "serve":
        return None
    ops = kernels.prepass(trace)
    if not ops:
        return None
    return kernels.seconds(ops) * 1e3 / trace.units
