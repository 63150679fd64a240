"""Set-up seconds the program spent on its capture cache, on the host's
clock: every probe frame that picks a bucket, and every warm-up and
capture of a graph (the program's tally ``capture_s``,
`utils/profiling.py` `SETUP_S`, read after the run). None where the
program keeps no such tally or it is zero."""


def read(trace):
    try:
        from cpp_cuda_raytracer_dev_torch.utils.profiling import SETUP_S
    except ImportError:
        return None
    return SETUP_S.get("capture_s") or None
