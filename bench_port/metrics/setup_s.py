"""Seconds from the harness's start to the first timed invocation: imports,
the card's first touch, the kernels' build where the checkout has none,
the weights, the image, the functions and the warm-up."""


def read(ctx):
    return ctx.setup_s
