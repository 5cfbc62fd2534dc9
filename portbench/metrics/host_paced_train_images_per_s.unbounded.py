"""The train rate, per layer, in the host-paced train cells whose runs
spread too widely to hold the rate to any bound the contract allows (the
host's speed paces them): all the measured window's images over all its
seconds, as ``host_paced_train_images_per_s`` reads it end to end where it
is steady. These cells report ``peak_mem_mib`` as their end-to-end metric
beside ``setup_s``, so this metric names that one as the metric it moves."""


def read(run, trace):
    return run.images / run.window_s
