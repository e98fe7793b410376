"""Milliseconds of kernel device time in the window's trace (the kernels'
durations summed), per million rows."""


def read(ctx):
    if not ctx.trace or not ctx.trace["kernels"] or not ctx.rows:
        return None
    return ctx.trace["kernel_s"] * 1e3 / (ctx.rows / 1e6)
