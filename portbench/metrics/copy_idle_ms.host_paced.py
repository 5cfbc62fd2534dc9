"""In the host-paced train cells, where it moves
``host_paced_train_images_per_s``: device idle milliseconds a traced step
in the gaps between the device's merged operations whose midpoint falls
while the host is inside the program's span ``batch_copy``: the card waits
on the batch's copy (``portbench/spans.idle_ms_in``), from the traced
window that also records the host's operators with their shapes, which
slows a host-paced step: the gaps there are longer than in an untraced
step."""

from portbench import spans


def read(run, trace):
    return spans.idle_ms_in(trace, ("batch_copy",))
