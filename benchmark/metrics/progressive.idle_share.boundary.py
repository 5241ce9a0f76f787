"""The device idle under the program's ``progressive.pass`` spans outside
their ``wavefront.tile`` spans (the kept graph's lookup and scene copy,
the film's copies in and out, the ray-count read) over the profiled
window."""
from benchmark import program_spans


def read(ctx):
    return program_spans.idle_share(ctx, {"progressive.pass"},
                                    outside={"wavefront.tile"})
