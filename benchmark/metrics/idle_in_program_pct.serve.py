"""Percent of the traced stretch of serving frames in which no operation
runs on the device while the host is inside the program's serving entry
span ``rt.render_jit``: the window's idle gaps (`Trace.gaps`) intersected
with the union of the entry spans, over the window. At most
`device_idle_pct.serve` of the same trace; the rest of that idle time the
host spends in the caller."""

from benchmark.harness import plugins


def idle_in(trace, kind: str):
    """The idle share inside the entry spans of ``kind``; None in a trace
    of the other kind or one without the span."""
    entry = plugins.load("metrics", "entry_host_ms.serve")
    if trace.kind != kind or trace.window_us <= 0:
        return None
    inside = []                     # the union of the entry spans
    for s, e in entry.spans(trace, entry.ENTRY[kind]):
        if inside and s <= inside[-1][1]:
            inside[-1][1] = max(inside[-1][1], e)
        else:
            inside.append([s, e])
    if not inside:
        return None
    idle, i = 0.0, 0
    for gs, ge in trace.gaps():
        while i < len(inside) and inside[i][1] <= gs:
            i += 1
        j = i
        while j < len(inside) and inside[j][0] < ge:
            idle += min(ge, inside[j][1]) - max(gs, inside[j][0])
            j += 1
    return 100.0 * idle / trace.window_us


def read(trace):
    return idle_in(trace, "serve")
