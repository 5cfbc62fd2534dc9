"""The share of the measured train window in which no operation ran on the
device, in percent: the device's busy time a step (the union of the device
operations' intervals in the traced window, over its steps) times the
measured window's steps, over the measured window's length. The traced
window's own idle share (``device.busy_s`` over ``device.window_s``) reads
higher on a host-paced step: tracing adds host time to every launch."""


def read(run, trace):
    busy_per_step = trace.busy_s() / trace.steps
    return 100.0 * (1.0 - busy_per_step * run.steps / run.window_s)
