"""Median ``PhaseTimes.communication`` of the cold starts outside the traced
part (ms): ``DependencyManager.request_migration``, the metadata transfer
and the page server's attach."""
import statistics


def read(ctx):
    v = [x.phases["communication"] for x in ctx.untraced("cold")]
    return statistics.median(v) * 1e3 if v else None
