"""Host milliseconds a served frame reading the live count of the bin
tables after the replay, a wait on the device: the spans
``rt.graphs.live`` (`utils/graphs.py` `GraphCache.grow`) inside the
serving entry span ``rt.render_jit``, summed over the traced stretch. A
frame without bin tables (the kd path) makes no such read."""

from benchmark.harness import plugins


def read(trace):
    return plugins.load("metrics", "launch_ms").nested_ms(trace,
                                                          "rt.graphs.live")
