"""Seconds of the program's `format` phase timer over the window, per
million rows.  The timers run in several threads, so phases overlap."""


def read(ctx):
    if not ctx.phases or "format" not in ctx.phases or not ctx.rows:
        return None
    return ctx.phases["format"] / (ctx.rows / 1e6)
