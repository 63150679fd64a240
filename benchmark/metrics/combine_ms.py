"""Device milliseconds a served frame combining the objects' hits: the
operations that start after each object's K1 (the bin intersect) and
before the next object's K8 triangle pass, or before K10 (shading) after
the last object. They are the untile of K1's tile-ordered hits, the object
id and the nearest-hit merge (`ops/intersect.py` `Hit.merge`). The fill
that zeroes K8's block counter, launched just before its pass, belongs to
the prepass and is left out. None where the frame runs no K1."""

from benchmark.harness import kernels

K10 = "shade_compose_kernel"        # csrc/shade.cu


def ops(trace) -> list:
    """The combine's device operations of every frame in the trace."""
    dev = trace.device
    out, i = [], 0
    while i < len(dev):
        if kernels.K1 not in dev[i][0]:
            i += 1
            continue
        j = i + 1
        while j < len(dev) and not any(
                k in dev[j][0] for k in (kernels.K1, kernels.K8[0], K10)):
            j += 1
        if j == len(dev) or kernels.K1 in dev[j][0]:
            i = j               # no next stage: not a frame's combine
            continue
        end = j
        if (kernels.K8[0] in dev[j][0] and end > i + 1
                and "fill" in dev[end - 1][0].lower()):
            end -= 1
        out += dev[i + 1:end]
        i = j
    return out


def read(trace):
    if trace.kind != "serve":
        return None
    found = ops(trace)
    if not any(kernels.K1 in ev[0] for ev in trace.device):
        return None
    return kernels.seconds(found) * 1e3 / trace.units
