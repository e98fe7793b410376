"""Seconds of the program's `fetch_wait` phase: the caller waiting for a
batch's copy to the host, over the window, per million rows."""


def read(ctx):
    if not ctx.phases or "fetch_wait" not in ctx.phases or not ctx.rows:
        return None
    return ctx.phases["fetch_wait"] / (ctx.rows / 1e6)
