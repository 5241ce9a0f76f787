"""95th percentile of the window's pass times (host clock, the
``on_chunk`` hook), seconds."""


def read(ctx):
    return ctx.layer.get("progressive.pass_s_p95")
