"""Median host us of a ``kernel.*`` span in the traced part: one call into a
kernel wrapper (``flash_attention``, ``diag_recurrence``, ``page_gather``,
``decode_attention``), its checks, the op's dispatch and the launch, on any
thread."""
import statistics

from bench_port import spantrace


def read(ctx):
    v = [(r.end_ns - r.start_ns) / 1e3 for r in spantrace.records(ctx)
         if r.name.startswith("kernel.")]
    return statistics.median(v) if v else None
