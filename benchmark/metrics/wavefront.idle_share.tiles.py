"""The device idle under the program's ``wavefront.tile`` spans (the
host's replays of the captured step and its all-done reads) over the
profiled window."""
from benchmark import program_spans


def read(ctx):
    return program_spans.idle_share(ctx, {"wavefront.tile"})
