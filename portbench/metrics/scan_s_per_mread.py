"""Seconds of the program's `scan` phase timer over the window, per
million rows.  The timers run in several threads, so phases overlap."""


def read(ctx):
    if not ctx.phases or "scan" not in ctx.phases or not ctx.rows:
        return None
    return ctx.phases["scan"] / (ctx.rows / 1e6)
