"""The device idle under the program's ``train.step`` spans (the graph's
lookup, the copies in, the replay, the clones out, the Adam update) over
the profiled window."""
from benchmark import program_spans


def read(ctx):
    return program_spans.idle_share(ctx, {"train.step"})
