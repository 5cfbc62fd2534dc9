"""As ``optimizer_device_ms.train``, in the host-paced train cells, where it
moves ``host_paced_train_images_per_s``: device milliseconds a train step
of the kernels launched inside torch's ``Optimizer.step`` range (Adam,
foreach)."""


def read(run, trace):
    return trace.region_ms_per_step("optimizer")
