"""The program's kernels by the name a device trace gives them (a replayed
graph moves no launch counter), and the device time they take."""

from __future__ import annotations

K1 = "own_walk_kernel"              # bin intersect, csrc/bin_intersect.cu
K2 = "segment_sum_level"            # gather backward, csrc/segment_sum.cu
K7 = "kd_traverse_kernel"           # KD traversal, csrc/kd_traverse.cu
K8 = ("tri_pass_kernel", "ray_table_kernel")      # csrc/bin_prepass.cu
K9 = ("entry_keys_kernel", "entry_table_kernel")  # csrc/bin_prepass.cu


def seconds(events) -> float:
    return sum(e - s for _, s, e in events) * 1e-6


def prepass(trace) -> list:
    """The binning prepass's device operations: from each K8 triangle pass
    to the K9 table after it, everything that starts in between (the
    cumsum, K9's keys, the sort and K8's ray table among them), and K8's
    ray table wherever it runs."""
    dev = trace.device
    out, i = set(), 0
    while i < len(dev):
        if K8[0] in dev[i][0]:
            j = i
            while j < len(dev) and K9[1] not in dev[j][0]:
                j += 1
            if j == len(dev):
                break
            out.update(range(i, j + 1))
            i = j + 1
        else:
            i += 1
    out.update(k for k, ev in enumerate(dev) if K8[1] in ev[0])
    return [dev[k] for k in sorted(out)]


def k2_call(trace) -> list:
    """K2's device operations: its level kernels and, before the first
    level of each call, the fill that zeroes its output."""
    dev = trace.device
    out = []
    for k, ev in enumerate(dev):
        if K2 not in ev[0]:
            continue
        if k and K2 not in dev[k - 1][0] and "fill" in dev[k - 1][0].lower():
            out.append(dev[k - 1])
        out.append(ev)
    return out
