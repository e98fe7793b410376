"""Milliseconds of the program's `drain` total, from a call's last batch's
dispatch until its last row chunk is taken: the tail in which the card
runs out of work, over the window, per pass."""


def read(ctx):
    if not ctx.phases or "drain" not in ctx.phases or not ctx.passes:
        return None
    return 1e3 * ctx.phases["drain"] / ctx.passes
