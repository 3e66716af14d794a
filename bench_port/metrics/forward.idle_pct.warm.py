"""The share of the traced warm invocations' ``forward`` spans (the port's
program spans, ``repro_torch.spans``) in which the device sat idle (%):
their summed idle time on the profiler's clock over their summed length."""
from bench_port import spantrace


def read(ctx):
    return spantrace.forward_idle_pct(ctx, cold=False)
