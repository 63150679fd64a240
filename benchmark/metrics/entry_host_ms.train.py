"""Host milliseconds a training step inside the program's training entry
point: its span ``rt.train_step`` around `make_train_step_jit`'s step
(the forward and backward graph through the capture cache, the live
count's read, then the optimizer's graph), summed over the traced
stretch."""

from benchmark.harness import plugins


def read(trace):
    return plugins.load("metrics", "entry_host_ms.serve").entry_ms(trace,
                                                                   "train")
