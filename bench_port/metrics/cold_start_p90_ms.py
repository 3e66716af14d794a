"""90th percentile, over every cold start completed in the window, of the
harness's clock from the call into ``cold_start_warmswap`` to the first
request's logits on the host (ms)."""
import numpy as np


def read(ctx):
    v = [x.seconds for x in ctx.invocations if x.kind == "cold"]
    return float(np.percentile(v, 90) * 1e3) if v else None
