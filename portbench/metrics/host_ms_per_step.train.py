"""Host milliseconds a train step spends inside the step call (the
dispatch of its work, and any wait the call makes on the device), the mean
over the measured window: the benchmark's own span around each call."""


def read(run, trace):
    return run.host_ms_per_step
