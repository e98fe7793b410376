"""Milliseconds of the program's `fill` total, from a call's start until
its first batch is dispatched: the card's wait for a pass's first work,
over the window, per pass."""


def read(ctx):
    if not ctx.phases or "fill" not in ctx.phases or not ctx.passes:
        return None
    return 1e3 * ctx.phases["fill"] / ctx.passes
