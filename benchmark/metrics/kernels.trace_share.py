"""The traversal kernels' share of the profiled device time: ``team_kernel``
(K1, K3, K2p) and ``binary_any_hit_kernel`` (K2) over every device op."""


def read(ctx):
    t = ctx.device_trace
    if t is None or not t.ops:
        return None
    trav = sum(s for _, s in t.traversal())
    return trav / t.device_s() if trav > 0 else None
