"""Set-up seconds the program spent building the KD tree and uploading its
tables, on the host's clock: `build_kd_fast` and `KDTables.from_tree` (the
program's tally ``kd_build_s``, `utils/profiling.py` `SETUP_S`). None
where the program keeps no such tally or built no tree."""


def read(trace):
    try:
        from cpp_cuda_raytracer_dev_torch.utils.profiling import SETUP_S
    except ImportError:
        return None
    return SETUP_S.get("kd_build_s") or None
