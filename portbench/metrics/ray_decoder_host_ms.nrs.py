"""Host milliseconds an NRS train step spends inside the program's span
``ray_decoder`` (``nn/raysurface.RaySurfaceResNet``'s ray-surface decoder,
its forward's dispatch), the mean over the recorded window
(``portbench/spans.py``). Nothing to read where the program opens no such
span."""

from portbench import spans


def read(run, trace):
    return spans.host_ms(run, "ray_decoder")
