"""Device milliseconds a served "pallas2" frame culling clusters and
building the candidate lists: the operations that start after the frame's
set-up kernel K11 and before K4's first pass (the tiles, the frustum cull,
the nearest candidates and their boxes), and those between K4's two
passes (the escalation's choice of tiles, its flat cull and boxes). K4's
own tile order (`longest_first_kernel`) is left out: `k4_ms` counts it.
None where the frame runs no K4."""

from benchmark.harness import kernels

K11 = "frame_setup_kernel"          # csrc/shade.cu
K10 = "shade_compose_kernel"        # csrc/shade.cu
K4 = "tile_intersect_kernel"        # csrc/tile_intersect.cu
ORDER = "longest_first_kernel"


def _next(dev, i: int, names) -> int:
    """The index of the first operation after ``i`` whose name holds any of
    ``names``; len(dev) where there is none."""
    j = i + 1
    while j < len(dev) and not any(n in dev[j][0] for n in names):
        j += 1
    return j


def ops(trace) -> list:
    """The cull's device operations of every frame in the trace."""
    dev = trace.device
    out = []
    for i, ev in enumerate(dev):
        if K11 not in ev[0]:
            continue
        first = _next(dev, i, (K4, K11))
        if first == len(dev) or K11 in dev[first][0]:
            continue            # no K4 in this frame
        stretch = dev[i + 1:first]
        second = _next(dev, first, (K4, K10, K11))
        if second < len(dev) and K4 in dev[second][0]:
            stretch += dev[first + 1:second]
        out += [op for op in stretch if ORDER not in op[0]]
    return out


def read(trace):
    if trace.kind != "serve" or not any(K4 in ev[0] for ev in trace.device):
        return None
    return kernels.seconds(ops(trace)) * 1e3 / trace.units
