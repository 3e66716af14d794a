"""Median ``PhaseTimes.execution`` of the cold starts outside the traced part
(ms): the first request through the handler, on the restored parameters."""
import statistics


def read(ctx):
    v = [x.phases["execution"] for x in ctx.untraced("cold")]
    return statistics.median(v) * 1e3 if v else None
