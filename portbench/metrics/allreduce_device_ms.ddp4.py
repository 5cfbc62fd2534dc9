"""Device milliseconds a traced step of rank 0 spends in the gradient
all-reduce: the summed time of its NCCL kernels whose name holds
'AllReduce' (``DistributedDataParallel``'s buckets), over the traced steps.
A kernel that overlaps the backward counts whole. Nothing to read where
the trace holds none (one rank, or gloo on the CPU)."""


def read(run, trace):
    ops = trace.ops_named("AllReduce")
    if not ops:
        return None
    return sum(s for _, s in ops) * 1e3 / trace.steps
