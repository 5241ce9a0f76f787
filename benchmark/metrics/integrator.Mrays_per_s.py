"""Traced rays (``RenderStats.n_rays``: camera, continuation and shadow
rays) of the window's passes over their host time, millions a second."""


def read(ctx):
    return ctx.layer.get("integrator.Mrays_per_s")
