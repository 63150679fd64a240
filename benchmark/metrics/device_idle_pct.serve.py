"""Percent of the traced stretch of serving frames in which no operation
ran on the device (one minus the union of the device intervals over the
window)."""


def read(trace):
    if trace.kind != "serve" or trace.window_us <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_us() / trace.window_us)
