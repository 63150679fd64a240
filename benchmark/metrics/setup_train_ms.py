"""Device milliseconds a training step in the training set-up's kernels:
K11 forward (`frame_setup_kernel`) and K13 backward (its ray pass
`frame_setup_grad_kernel` and its chain `frame_setup_grad_chain_kernel`),
all in csrc/shade.cu, found by name. Silent where a step runs no K13 (a
program whose steps set up the camera through autograd)."""

from benchmark.harness import kernels

K11 = "frame_setup_kernel"
K13 = "frame_setup_grad"      # both of its kernels' names hold it


def read(trace):
    if trace.kind != "train" or not trace.named(K13):
        return None
    return kernels.seconds(trace.named(K11, K13)) * 1e3 / trace.units
