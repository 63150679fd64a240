"""Host milliseconds a served frame launching the program's captured
graph: its spans ``rt.graphs.launch`` (`utils/graphs.py` `GraphCache.run`,
each ``graph.replay()``) inside the serving entry span ``rt.render_jit``,
summed over the traced stretch. The live count's reader
(`live_wait_ms`) uses its helper."""

from benchmark.harness import plugins


def nested_ms(trace, name: str):
    """Milliseconds a frame in the spans ``name`` that lie inside a serving
    entry span; None in a training trace or where there is none."""
    entry = plugins.load("metrics", "entry_host_ms.serve")
    if trace.kind != "serve":
        return None
    outer = entry.spans(trace, entry.ENTRY["serve"])
    inner = [(s, e) for s, e in entry.spans(trace, name)
             if any(a <= s and e <= b for a, b in outer)]
    if not inner:
        return None
    return sum(e - s for s, e in inner) * 1e-3 / trace.units


def read(trace):
    return nested_ms(trace, "rt.graphs.launch")
