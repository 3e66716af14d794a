"""Every invocation completed in the window, over the window's seconds (the
window closes when the last invocation started inside it completes)."""


def read(ctx):
    return len(ctx.invocations) / ctx.window_s if ctx.invocations else None
