"""Seconds of the program's `queue_full` phase: the dispatch worker holding
a dispatched batch while the bounded queue is full (blocked by fetch and
format), over the window, per million rows."""


def read(ctx):
    if not ctx.phases or "queue_full" not in ctx.phases or not ctx.rows:
        return None
    return ctx.phases["queue_full"] / (ctx.rows / 1e6)
