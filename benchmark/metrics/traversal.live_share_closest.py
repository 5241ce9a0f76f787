"""The closest-hit rays (``RenderStats.n_closest``) over the
lanes the closest-hit launches (K1, K3) covered, live or dead, summed over the
profiled passes' ``wavefront.film`` spans.  On a scene with instanced
groups, each group's launch covers instances x rays lanes, so there the
share is of the launched lanes, not of the lanes a ray could use."""
from benchmark import program_spans


def read(ctx):
    return program_spans.live_share(ctx, "n_closest", "closest_lanes")
