"""Seconds of the program's `device_wait` phase timer over the window, per
million rows.  The timers run in several threads, so phases overlap."""


def read(ctx):
    if not ctx.phases or "device_wait" not in ctx.phases or not ctx.rows:
        return None
    return ctx.phases["device_wait"] / (ctx.rows / 1e6)
