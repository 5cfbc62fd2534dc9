"""Device milliseconds a train step of kernels launched by rank-4
convolution operators, forward and backward (cuDNN)."""


def read(run, trace):
    return trace.group_ms_per_step("conv2d")
