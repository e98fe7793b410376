"""Seconds of the program's `cycle_accumulate` phase timer over the window,
per million rows: the caller's host add (or append) of each batch's
fetched chunk result."""


def read(ctx):
    if not ctx.phases or "cycle_accumulate" not in ctx.phases or not ctx.rows:
        return None
    return ctx.phases["cycle_accumulate"] / (ctx.rows / 1e6)
