"""Device milliseconds a train step of kernels launched by rank-5
convolution operators, forward and backward: the packed 3D convolution of
``ops/fold_conv.channel_conv3d``."""


def read(run, trace):
    return trace.group_ms_per_step("conv3d")
