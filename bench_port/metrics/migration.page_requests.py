"""Mean ``MigrationStats.requests`` of a cold start outside the traced part:
the page server's fetches (one ``page_gather`` each), a count."""
import statistics


def read(ctx):
    v = [x.migration["requests"] for x in ctx.untraced("cold")]
    return statistics.fmean(v) if v else None
