"""The lanes whose material sample the step uses (``RenderStats.
n_shaded``: a live hit on a BSDF material) over the lanes the material
kinds' samples ran over (``bsdf_lanes``: kinds present x the tiles' lanes
x steps; ``sample_material`` samples every kind on every lane), summed
over the profiled passes' ``wavefront.film`` spans.  None from a program
that does not count it."""
from benchmark import program_spans


def read(ctx):
    return program_spans.live_share(ctx, "n_shaded", "bsdf_lanes")
