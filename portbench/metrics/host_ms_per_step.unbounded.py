"""As ``host_ms_per_step.train``, in the host-paced train cells whose rate
is reported per layer (``host_paced_train_images_per_s.unbounded``): host
milliseconds a train step spends inside the step call, the mean over the
measured window: the benchmark's own span around each call."""


def read(run, trace):
    return run.host_ms_per_step
