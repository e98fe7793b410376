"""The least time the window's classification could take (its passes'
floor bytes, portbench/roofline.py, over the chip's memory bandwidth) as a
share of the kernels' summed device time in the trace, in percent."""

from portbench import roofline


def read(ctx):
    if not ctx.trace or not ctx.trace["kernel_s"] or not ctx.floor_bytes:
        return None
    return roofline.share_pct(ctx.floor_bytes * ctx.passes,
                              ctx.trace["kernel_s"], ctx.kind)
