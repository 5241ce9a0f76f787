"""The traced rays that escaped to the environment light
(``RenderStats.n_escape``, camera misses included) over the lanes each of
its lookups ran over (``env_lanes``: the tiles' lanes x steps), summed
over the profiled passes' ``wavefront.film`` spans: the share of the
step's sky radiance and MIS pdf work that a lane uses.  None on a scene
without an environment light, or a program that does not count it."""
from benchmark import program_spans


def read(ctx):
    return program_spans.live_share(ctx, "n_escape", "env_lanes")
