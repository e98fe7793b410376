"""Seconds of the program's `pack` phase timer over the window, per
million rows.  The timers run in several threads, so phases overlap."""


def read(ctx):
    if not ctx.phases or "pack" not in ctx.phases or not ctx.rows:
        return None
    return ctx.phases["pack"] / (ctx.rows / 1e6)
