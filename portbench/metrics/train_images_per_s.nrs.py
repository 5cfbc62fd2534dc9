"""The NRS train rate, per layer: all the measured window's images over all
its seconds, as ``train_images_per_s`` reads it end to end. The NRS cell
reports ``peak_mem_mib`` and ``setup_s`` end to end (an end-to-end rate
lists its cells, and a new cell joins one only by an edit of that entry),
so this metric names ``peak_mem_mib`` as the metric it moves."""


def read(run, trace):
    return run.images / run.window_s
