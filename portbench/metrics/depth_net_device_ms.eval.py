"""Device milliseconds an eval step of the kernels launched inside the
program's ``depth_net`` range: the forward of the straight and flipped
images."""


def read(run, trace):
    return trace.region_ms_per_step("depth_net")
