"""Regrowths of the capture cache in the traced stretch of a served
window: frames whose live count (bin table entries, or the tiles and
candidates of "pallas2"'s exact escalation) outgrew the bucket they were
captured at, and were redone at a larger one. Each is the program's span
``rt.graphs.regrow`` (`utils/graphs.py` `GraphCache.grow`, the counter
``GraphCache.regrown``); the stretch is one whole script cycle, so a pose
whose count the warm-up's buckets do not hold shows here. None where the
program has no such span."""


def read(trace):
    if trace.kind != "serve":
        return None
    try:
        from cpp_cuda_raytracer_dev_torch.utils.graphs import REGROW_SPAN
    except ImportError:
        return None
    lo, hi = trace.window
    return float(sum(1 for n, s, _ in trace.host
                     if n == REGROW_SPAN and lo <= s <= hi))
