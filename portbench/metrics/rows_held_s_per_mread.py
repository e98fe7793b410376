"""Seconds of the program's `rows_held` phase: the caller's own time with
each row chunk, from the yield until it asks for the next (inside
`format`), over the window, per million rows."""


def read(ctx):
    if not ctx.phases or "rows_held" not in ctx.phases or not ctx.rows:
        return None
    return ctx.phases["rows_held"] / (ctx.rows / 1e6)
