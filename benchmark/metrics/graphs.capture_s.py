"""The first call of the timed entry (warm-up and CUDA graph capture)
minus a kept call of the same work, both in set-up, seconds."""


def read(ctx):
    return ctx.layer.get("graphs.capture_s")
