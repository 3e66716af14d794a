"""flash_attention's share of its roofline in the traced part (%): for every
layer of every traced prompt one causal call (q, k, v read once, the output
written once; 4 FLOPs a multiply-add pair over the pairs the causal window
leaves), each bound by the larger of bytes at 3.35 TB/s and operations at
989 TFLOP/s, over the summed device time of the flash kernels in the trace."""
from bench_port import devtrace, work


def read(ctx):
    c = ctx.config
    if ctx.trace is None or "num_attention_heads" not in c:
        return None
    bound = 0.0
    for x in ctx.traced():
        moved, ops = work.flash_work(1, c["num_attention_heads"], c["num_key_value_heads"],
                                     x.length, c["head_dim"], c["sliding_window"])
        bound += c["num_hidden_layers"] * work.bound_s(moved, ops)
    seconds, _ = devtrace.kernel_s(ctx.trace, "flash_tc_kernel", "flash_fwd_kernel")
    if not bound or not seconds:
        return None
    return 100.0 * bound / seconds
