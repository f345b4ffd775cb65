"""Process start to the first timed step: imports, weights, caches, the
kernels' load or build, the warm-up requests and ``run``'s own warm-up."""


def read(ctx):
    return ctx.setup_s
