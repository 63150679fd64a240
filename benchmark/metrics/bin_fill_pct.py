"""How full the bin tables of a served frame are: each object's live
entries over the capacity its table is sized at (one bucket serves every
object of a frame), in percent, the mean over the objects. Read after the
window from the program's counter of the last frame `render_jit` ran
(`utils/profiling.py` `bin_fill`), which keeps the counts a frame makes
anyway: a frame makes no read and launches nothing for it. None where the
program keeps no such counter or the frame built no bin tables."""


def read(trace):
    if trace.kind != "serve":
        return None
    try:
        from cpp_cuda_raytracer_dev_torch.utils.profiling import bin_fill
    except ImportError:
        return None
    fill = bin_fill()
    if fill is None:
        return None
    counts, capacity = fill
    return 100.0 * sum(counts) / (len(counts) * capacity)
