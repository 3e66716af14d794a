"""The share of the traced window in which no operation ran on the device
(%): one minus the union of the profiler's device intervals over the
window."""
from bench_port import devtrace


def read(ctx):
    if ctx.trace is None or not ctx.trace.ops or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - devtrace.busy_s(ctx.trace) / ctx.trace.window_s)
