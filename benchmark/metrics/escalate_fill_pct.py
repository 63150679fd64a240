"""How full the bucket of "pallas2"'s exact escalation is in a served
frame: the tiles whose candidate list overflowed, every one of them
escalated, over the tiles the frame is captured to escalate, in percent,
the mean over the objects. Read after the window from the program's
counter of the last frame `render_jit` ran (`utils/profiling.py`
`escalate_fill`), which keeps the counts a frame makes anyway. None where
the program keeps no such counter or the frame escalated at no bucket."""


def read(trace):
    if trace.kind != "serve":
        return None
    try:
        from cpp_cuda_raytracer_dev_torch.utils.profiling import \
            escalate_fill
    except ImportError:
        return None
    fill = escalate_fill()
    if fill is None:
        return None
    counts, bucket = fill
    return 100.0 * sum(counts) / (len(counts) * bucket)
