"""Percent of the traced stretch of training steps in which no operation
runs on the device while the host is inside the program's training entry
span ``rt.train_step`` (as `idle_in_program_pct.serve`). At most
`device_idle_pct.train` of the same trace."""

from benchmark.harness import plugins


def read(trace):
    return plugins.load("metrics", "idle_in_program_pct.serve").idle_in(
        trace, "train")
