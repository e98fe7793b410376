"""Seconds of the program's `scan_wait` phase: the dispatch worker's
planner waiting for the scan thread (starved), over the window, per
million rows."""


def read(ctx):
    if not ctx.phases or "scan_wait" not in ctx.phases or not ctx.rows:
        return None
    return ctx.phases["scan_wait"] / (ctx.rows / 1e6)
