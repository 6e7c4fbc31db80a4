"""The card's idle share over the traced jobs: one less the union of its
kernels, copies and memsets over the stretch from the first job's start
to the last one's end."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
