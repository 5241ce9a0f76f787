"""Wavefront steps a pass runs: ``RenderStats.n_steps`` of the window's
passes over their number."""


def read(ctx):
    return ctx.layer.get("integrator.steps_per_pass")
