"""Host milliseconds an NRS train step spends inside the program's span
``generic_project`` (``geometry/camera_generic.generic_project``: the
points' and rays' resizes, the directions, the soft-argmax's dispatch and
the coordinates' resize, once a context), summed over the step's calls,
the mean over the recorded window (``portbench/spans.py``). Nothing to
read where the program opens no such span."""

from portbench import spans


def read(run, trace):
    return spans.host_ms(run, "generic_project")
