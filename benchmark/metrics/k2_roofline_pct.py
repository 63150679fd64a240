"""Kernel K2's share of its roofline in a training step: the least time
its contract's bytes (`rooflines/k2.py`) take at the card's published
memory rate, over the device time of its call (its levels and the fill of
its output), in percent."""

from benchmark.harness import kernels
from benchmark.harness.peaks import PEAKS
from benchmark.rooflines import k2


def read(trace):
    ops = kernels.k2_call(trace)
    peak = PEAKS.get(trace.device_kind)
    if trace.kind != "train" or not ops or peak is None:
        return None
    need = k2.bytes_moved(trace.shapes["rays"], trace.shapes["triangles"])
    least = need / peak["hbm_bytes_per_s"] * trace.units
    return 100.0 * least / kernels.seconds(ops)
