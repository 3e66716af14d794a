"""95th percentile, over every warm invocation completed in the window, of
the harness's clock around ``FunctionInstance.invoke`` (ms)."""
import numpy as np


def read(ctx):
    v = [x.seconds for x in ctx.invocations if x.kind == "warm"]
    return float(np.percentile(v, 95) * 1e3) if v else None
