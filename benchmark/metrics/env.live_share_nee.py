"""The NEE shadow rays sent to the environment light
(``RenderStats.n_env_nee``: the sky picked, the lane lit and shaded) over
the lanes each of its lookups ran over (``env_lanes``: the tiles' lanes x
steps), summed over the profiled passes' ``wavefront.film`` spans: the
share of the step's sky sampling (the CDF searches) that a lane uses.
None on a scene without an environment light, or a program that does not
count it."""
from benchmark import program_spans


def read(ctx):
    return program_spans.live_share(ctx, "n_env_nee", "env_lanes")
