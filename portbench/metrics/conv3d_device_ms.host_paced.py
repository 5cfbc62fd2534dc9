"""As ``conv3d_device_ms.train``, in the host-paced train cells, where it
moves ``host_paced_train_images_per_s``: device milliseconds a train step
of kernels launched by rank-5 convolution operators, forward and backward:
the packed 3D convolution of ``ops/fold_conv.channel_conv3d``."""


def read(run, trace):
    return trace.group_ms_per_step("conv3d")
