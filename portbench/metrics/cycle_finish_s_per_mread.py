"""Seconds of the program's `cycle_finish` phase timer over the window, per
million rows: the caller's scoring of each batch once every chunk has
been probed: the host top-2 over the summed counts, or the device top-2
over the labels; the format is apart."""


def read(ctx):
    if not ctx.phases or "cycle_finish" not in ctx.phases or not ctx.rows:
        return None
    return ctx.phases["cycle_finish"] / (ctx.rows / 1e6)
