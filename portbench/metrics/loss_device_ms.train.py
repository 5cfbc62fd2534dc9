"""Device milliseconds a train step of the kernels launched inside the
program's ranges ``photometric_loss`` and ``supervised_loss`` (the losses'
forward; their backward runs outside the ranges)."""


def read(run, trace):
    return trace.region_ms_per_step("photometric_loss", "supervised_loss")
