"""diag_recurrence's share of its roofline in the traced part (%): the bytes
and operations of every call the traced prompts make (one per SSM layer and
chunk of 256 positions: a, b and h_all in fp32 once), bound by the larger of
bytes at 3.35 TB/s and operations at the fp32 peak, over the summed device
time of the recurrence's kernels in the trace."""
from bench_port import devtrace, work


def read(ctx):
    c = ctx.config
    if ctx.trace is None or "state_size" not in c:
        return None
    channels = c["intermediate_size"] * c["state_size"]
    moved = ops = 0
    for x in ctx.traced():
        m, o = work.ssm_prefill_recurrence(x.length, channels, c["num_hidden_layers"])
        moved, ops = moved + m, ops + o
    seconds, _ = devtrace.kernel_s(ctx.trace, "diag_recurrence_kernel",
                                   "chunk_summary_kernel", "chunk_apply_kernel")
    if not moved or not seconds:
        return None
    return 100.0 * work.bound_s(moved, ops, "float32") / seconds
