"""CSV rows the window produced (one a read) over the window's seconds;
the window ends with the pass that crosses --seconds."""


def read(ctx):
    return ctx.rows / ctx.window_s if ctx.window_s > 0 else None
