"""Device operations (kernels, copies, fills) a training step, over the
traced stretch."""


def read(trace):
    if trace.kind != "train" or not trace.device:
        return None
    return len(trace.device) / trace.units
