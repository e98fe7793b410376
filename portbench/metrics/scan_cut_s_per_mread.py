"""Seconds of the program's `scan_cut` phase: the scan thread's record-cut
search of each chunk, outside the `scan` phase, over the window, per
million rows."""


def read(ctx):
    if not ctx.phases or "scan_cut" not in ctx.phases or not ctx.rows:
        return None
    return ctx.phases["scan_cut"] / (ctx.rows / 1e6)
