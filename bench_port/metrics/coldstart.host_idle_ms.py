"""Median, over the traced cold starts, of the ms the device sat idle inside
the port's ``coldstart`` span but outside its first request's ``forward``:
boot, the restore, the handler's import, the handler around the forward,
and the release, on the profiler's clock."""
from bench_port import spantrace


def read(ctx):
    return spantrace.coldstart_host_idle_ms(ctx)
