"""Device milliseconds a training step in the training shading's two
kernels: K10 forward (`shade_compose_kernel`) and K12 backward
(`shade_grad_kernel`), both in csrc/shade.cu, found by name. Silent where
a step runs neither (a program whose steps shade through autograd)."""

from benchmark.harness import kernels

NAMES = ("shade_compose_kernel", "shade_grad_kernel")


def read(trace):
    ops = trace.named(*NAMES)
    if trace.kind != "train" or not ops:
        return None
    return kernels.seconds(ops) * 1e3 / trace.units
