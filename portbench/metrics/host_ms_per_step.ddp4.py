"""As ``host_ms_per_step.train``, in the four-rank cell: host milliseconds
rank 0's train step spends inside the step call (the dispatch of its work,
the command to the other ranks, and any wait the call makes on the
device), the mean over the measured window."""


def read(run, trace):
    return run.host_ms_per_step
