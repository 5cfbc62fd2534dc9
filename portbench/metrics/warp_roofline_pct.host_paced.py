"""The warp kernels' share of their roofline over a train step, in the
host-paced train cells (the self-supervised ones, which warp): the least
time of the step's warp launches (``rooflines/warp.py``, from the cell's
shapes), summed, over the device time of the traced warp kernels, summed,
in percent. Nothing to read where the step launches no warp, or where the
traced launches are not whole steps' worth."""


def read(run, trace):
    launches = run.cell.warp_launches()
    traced = trace.ops_named("warp_fwd_kernel", "warp_bwd_kernel")
    if not launches or not traced or len(traced) != len(launches) * trace.steps:
        return None
    bound = sum(s for _, s in launches) * trace.steps
    return 100.0 * bound / sum(s for _, s in traced)
