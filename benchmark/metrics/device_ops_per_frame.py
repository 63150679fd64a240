"""Device operations (kernels, copies, fills) a served frame, over the
traced stretch."""


def read(trace):
    if trace.kind != "serve" or not trace.device:
        return None
    return len(trace.device) / trace.units
