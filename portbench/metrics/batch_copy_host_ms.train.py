"""Host milliseconds a train step spends inside the program's span
``batch_copy`` (every host array of the batch moved to the card and made
float32, ``engine/train.prepare_train_batch``; a copy from pageable host
memory waits there for the work queued before it), the mean over the
recorded window (``portbench/spans.py``: the cell's steps back to back
with the program's span recorder on and no profiler)."""

from portbench import spans


def read(run, trace):
    return spans.host_ms(run, "batch_copy")
