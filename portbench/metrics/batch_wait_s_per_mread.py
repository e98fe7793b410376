"""Seconds of the program's `batch_wait` phase: the caller waiting for a
dispatched batch (starved), over the window, per million rows."""


def read(ctx):
    if not ctx.phases or "batch_wait" not in ctx.phases or not ctx.rows:
        return None
    return ctx.phases["batch_wait"] / (ctx.rows / 1e6)
