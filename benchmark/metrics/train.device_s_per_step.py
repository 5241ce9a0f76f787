"""Device time (summed over the card's ops) of the profiled fit steps
over their number, seconds a step."""


def read(ctx):
    t, steps = ctx.device_trace, ctx.counts.get("steps")
    if t is None or not steps or not t.ops:
        return None
    return t.device_s() / steps
