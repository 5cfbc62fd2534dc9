"""Device milliseconds a train step of the kernels launched inside torch's
``Optimizer.step`` range (Adam, foreach)."""


def read(run, trace):
    return trace.region_ms_per_step("optimizer")
