"""The cold starts' share of the card's bf16 peak outside the traced part
(%): the model FLOPs of their first requests (``reference/<family>.py``
``model_flops``), over their summed latency times 989 TFLOP/s."""
from bench_port import work


def read(ctx):
    v = ctx.untraced("cold")
    if not v:
        return None
    flops = sum(ctx.family.model_flops(ctx.config, x.length) for x in v)
    return 100.0 * flops / (sum(x.seconds for x in v) * work.PEAK_FLOPS["bfloat16"])
