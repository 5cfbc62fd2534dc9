"""As ``host_ms_per_step.train``, in the host-paced train cells, where it
moves ``host_paced_train_images_per_s``: host milliseconds a train step
spends inside the step call (the dispatch of its work, and any wait the
call makes on the device), the mean over the measured window: the
benchmark's own span around each call."""


def read(run, trace):
    return run.host_ms_per_step
