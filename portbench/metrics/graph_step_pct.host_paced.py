"""% of the recorded window's train steps in the host-paced train cell whose rate is bounded that replayed the
program's captured CUDA graph (the step records' counter ``graph_replays``,
``portbench/graph_steps.py``); None where the program counts none."""

from portbench import graph_steps


def read(run, trace):
    return graph_steps.step_pct(run)
