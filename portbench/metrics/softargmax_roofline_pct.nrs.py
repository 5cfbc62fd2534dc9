"""The soft-argmax kernels' share of their roofline over an NRS train step:
the least time of the step's K6f and K6b launches (``rooflines/
softargmax.py``, from the cell's shapes), summed, over the device time of
the traced ``softargmax_fwd_kernel`` and ``softargmax_bwd_kernel``
launches, summed, in percent. Nothing to read where the cell launches no
soft-argmax, or where the traced launches are not whole steps' worth."""


def read(run, trace):
    launches_of = getattr(run.cell, "softargmax_launches", None)
    launches = launches_of() if launches_of is not None else []
    traced = trace.ops_named("softargmax_fwd_kernel", "softargmax_bwd_kernel")
    if not launches or not traced or len(traced) != len(launches) * trace.steps:
        return None
    bound = sum(s for _, s in launches) * trace.steps
    return 100.0 * bound / sum(s for _, s in traced)
