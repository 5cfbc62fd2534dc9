"""Host milliseconds an eval step spends inside the program's
``depth_metrics`` range (the flip post-process and the 7 metrics in 4
modes), in the traced window."""


def read(run, trace):
    return trace.host_range_ms_per_step("depth_metrics")
