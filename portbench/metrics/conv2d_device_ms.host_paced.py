"""As ``conv2d_device_ms.train``, in the host-paced train cells, where it
moves ``host_paced_train_images_per_s``: device milliseconds a train step
of kernels launched by rank-4 convolution operators, forward and backward
(cuDNN)."""


def read(run, trace):
    return trace.group_ms_per_step("conv2d")
