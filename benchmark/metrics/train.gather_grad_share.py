"""The share of the profiled fit steps' device time spent in the backward
of the material-table gathers: autograd's ``index_put_`` with accumulate
(torch's ``indexing_backward_kernel*``) or the program's own kernel
(``gather_rows_grad``), over every device op."""

NAMES = ("indexing_backward_kernel", "gather_rows_grad")


def read(ctx):
    t = ctx.device_trace
    if t is None or not t.ops:
        return None
    gather = sum(e - s for n, s, e in t.ops if any(k in n for k in NAMES))
    return gather / 1e9 / t.device_s()
