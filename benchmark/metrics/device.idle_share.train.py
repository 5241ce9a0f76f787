"""1 - the union of the device ops' intervals over the profiled fit steps'
wall time."""


def read(ctx):
    t = ctx.device_trace
    if t is None or not t.ops:
        return None
    return t.idle_share()
