"""Device ops (kernels, copies, sets) of the profiled passes over their
wavefront steps."""


def read(ctx):
    t, steps = ctx.device_trace, ctx.counts.get("steps")
    if t is None or not steps or not t.ops:
        return None
    return len(t.ops) / steps
