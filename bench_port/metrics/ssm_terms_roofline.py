"""ssm_terms' share of its roofline in the traced part (%): the bytes of every
call the traced prompts make (one per SSM layer and chunk of 256 positions,
B = 1: a and b written once in fp32; the raw dt and x read once and B read
once, in the configuration's dtype; A_log and dt_bias once a call, in fp32)
at 3.35 TB/s, over the summed device time of the ``ssm_terms`` kernels in
the trace. Nothing where the program has no such kernel."""
from bench_port import devtrace, work

ESIZE = {"bfloat16": 2, "float32": 4}


def call_bytes(s: int, di: int, n: int, esize: int) -> int:
    """One call over ``s`` positions of ``di`` channels and ``n`` states."""
    return 2 * s * di * n * 4 + 2 * s * di * esize + s * n * esize + di * n * 4 + di * 4


def read(ctx):
    c = ctx.config
    if ctx.trace is None or "state_size" not in c:
        return None
    di, n = c["intermediate_size"], c["state_size"]
    esize = ESIZE[c["torch_dtype"]]
    moved = 0
    for x in ctx.traced():
        for c0 in range(0, x.length, work.SSM_CHUNK):
            moved += call_bytes(min(work.SSM_CHUNK, x.length - c0), di, n, esize)
    moved *= c["num_hidden_layers"]
    seconds, _ = devtrace.kernel_s(ctx.trace, "ssm_terms_kernel")
    if not moved or not seconds:
        return None
    return 100.0 * work.bound_s(moved, 0) / seconds
