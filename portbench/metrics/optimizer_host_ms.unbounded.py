"""As ``optimizer_host_ms.train``, in the host-paced train cells whose rate
is reported per layer (``host_paced_train_images_per_s.unbounded``): host
milliseconds a train step spends inside the program's span
``optimizer_step``, the mean over the recorded window
(``portbench/spans.py``: the cell's steps back to back with the program's
span recorder on and no profiler)."""

from portbench import spans


def read(run, trace):
    return spans.host_ms(run, "optimizer_step")
