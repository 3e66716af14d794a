"""page_gather's share of its roofline in the traced part (%): the bytes the
traced cold starts gathered, each read once and written once, at 3.35 TB/s,
over the summed device time of the ``page_gather`` kernels in the trace."""
from bench_port import devtrace, work


def read(ctx):
    if ctx.trace is None:
        return None
    moved = sum(work.gather_work(x.migration["bytes_transferred"])
                for x in ctx.traced("cold"))
    seconds, _ = devtrace.kernel_s(ctx.trace, "page_gather")
    if not moved or not seconds:
        return None
    return 100.0 * work.bound_s(moved, 0) / seconds
