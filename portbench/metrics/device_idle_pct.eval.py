"""The share of the measured eval window in which no operation ran on the
device, in percent (as ``device_idle_pct.train``)."""


def read(run, trace):
    busy_per_step = trace.busy_s() / trace.steps
    return 100.0 * (1.0 - busy_per_step * run.steps / run.window_s)
