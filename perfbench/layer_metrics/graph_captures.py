"""``graph_captures.<cell kind>``: CUDA-graph captures the program made
inside the window (its ``GraphCache`` counters after minus before): 0 once
warm-up covered every shape."""

from perfbench.harness.readers import counter


def read(ctx):
    return counter(ctx, "graph_captures")
