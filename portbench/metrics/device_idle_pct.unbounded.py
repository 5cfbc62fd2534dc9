"""As ``device_idle_pct.train``, in the host-paced train cells whose rate
is reported per layer (``host_paced_train_images_per_s.unbounded``): the
share of the measured train window in which no operation ran on the
device, in percent, from the traced window's busy time a step."""


def read(run, trace):
    busy_per_step = trace.busy_s() / trace.steps
    return 100.0 * (1.0 - busy_per_step * run.steps / run.window_s)
