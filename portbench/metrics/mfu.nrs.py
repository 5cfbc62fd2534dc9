"""As ``mfu.train``, in the NRS train cell: the whole train step's share of
the card's peak: the model FLOPs of a step (convolutions and matrix
products of the reference's forward and backward at the cell's shapes, no
recomputation) times the measured window's steps, over its seconds, over
the peak the configuration names for the cell's precision, in percent."""


def read(run, trace):
    return 100.0 * run.flops_per_step() * run.steps / run.window_s / run.peak_flops
