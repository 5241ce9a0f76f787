"""The NEE shadow rays (``RenderStats.n_shadow``) over the
lanes the any-hit launches (K2, K2p) covered, live or dead, summed over the
profiled passes' ``wavefront.film`` spans.  On a scene with instanced
groups, each group's launch covers instances x rays lanes, so there the
share is of the launched lanes, not of the lanes a ray could use."""
from benchmark import program_spans


def read(ctx):
    return program_spans.live_share(ctx, "n_shadow", "any_hit_lanes")
