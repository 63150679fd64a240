"""Device milliseconds a served frame in kernel K4, the "pallas2" tile
intersect (``csrc/tile_intersect.cu`` `tile_intersect_kernel`), both of
its passes (the first and the escalation), with the `longest_first_kernel`
that orders a pass's tiles just before it. None where the frame runs no
K4."""

from benchmark.harness import kernels

K4 = "tile_intersect_kernel"        # csrc/tile_intersect.cu
ORDER = "longest_first_kernel"      # K4's tile order (K1 has its own)


def ops(trace) -> list:
    """K4's launches and the tile orders launched just before them."""
    dev = trace.device
    return [ev for k, ev in enumerate(dev)
            if K4 in ev[0] or (ORDER in ev[0] and k + 1 < len(dev)
                               and K4 in dev[k + 1][0])]


def read(trace):
    found = ops(trace)
    if trace.kind != "serve" or not found:
        return None
    return kernels.seconds(found) * 1e3 / trace.units
