"""Median ``PhaseTimes.migration`` of the cold starts outside the traced part
(ms): the restore until the parameters are usable (the BULK stream joined)."""
import statistics


def read(ctx):
    v = [x.phases["migration"] for x in ctx.untraced("cold")]
    return statistics.median(v) * 1e3 if v else None
