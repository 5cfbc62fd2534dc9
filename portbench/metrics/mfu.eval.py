"""The whole eval step's share of the card's peak: the convolution FLOPs
of the reference's forward of the 2B straight and flipped images times the
measured window's steps, over its seconds, over the peak the configuration
names for the cell's precision, in percent."""


def read(run, trace):
    return 100.0 * run.flops_per_step() * run.steps / run.window_s / run.peak_flops
