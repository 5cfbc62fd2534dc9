"""The four-rank train rate, per layer: all the measured window's images,
every rank's, over all its seconds (rank 0's clock: the other ranks take
the same steps in the same window). The cell reports ``peak_mem_mib`` and
``setup_s`` end to end (an end-to-end rate lists its cells, and a new cell
joins one only by an edit of that entry), so this metric names
``peak_mem_mib`` as the metric it moves."""


def read(run, trace):
    return run.images / run.window_s
