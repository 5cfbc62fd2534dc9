"""As ``device_idle_pct.train``, in the NRS train cell: the share of the
measured window in which no operation ran on the device, in percent: the
device's busy time a step (the union of the device operations' intervals
in the traced window, over its steps) times the measured window's steps,
over the measured window's length."""


def read(run, trace):
    busy_per_step = trace.busy_s() / trace.steps
    return 100.0 * (1.0 - busy_per_step * run.steps / run.window_s)
