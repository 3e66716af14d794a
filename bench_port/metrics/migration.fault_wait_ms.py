"""Median ``MigrationStats.fault_wait_s`` of the cold starts outside the
traced part (ms): the time the cold start blocked on pages, its first
fault and, under BULK, its wait for the stream to finish."""
import statistics


def read(ctx):
    v = [x.migration["fault_wait_s"] for x in ctx.untraced("cold")]
    return statistics.median(v) * 1e3 if v else None
