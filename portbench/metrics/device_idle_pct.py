"""The share of the traced window in which no kernel, copy or memset ran
on the device (one minus the union of their intervals), in percent."""


def read(ctx):
    if not ctx.trace or not ctx.trace["window_s"]:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
