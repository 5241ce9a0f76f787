"""The traversal launches' share of their roofline, percent: the sum of
each launch's bound (``yardstick.traversal_bound_s``: its lanes' ray rows
read once and results written once, at peak bandwidth) over the sum of
their device times.  Every launch of a cell has the cell's
``traversal_lanes`` lanes (one tile, or the fit's pixel block; the
benchmark's scenes have no instanced groups)."""
from benchmark import yardstick


def read(ctx):
    t, lanes = ctx.device_trace, ctx.counts.get("traversal_lanes")
    if t is None or not lanes:
        return None
    launches = t.traversal()
    took = sum(s for _, s in launches)
    if took <= 0:
        return None
    bound = sum(yardstick.traversal_bound_s(n, lanes) for n, _ in launches)
    return 100.0 * bound / took
