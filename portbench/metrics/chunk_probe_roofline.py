"""The least time the window's classification could take (its passes'
floor bytes, portbench/roofline.py, over the chip's memory bandwidth) as a
share of K7's device time in the trace (the chunk probe's three kernels,
chunk_probe_ms_per_mread), in percent."""

from portbench import roofline
from portbench.metrics import chunk_probe_ms_per_mread as k7


def read(ctx):
    s = k7.seconds(ctx)
    if not s or not ctx.floor_bytes:
        return None
    return roofline.share_pct(ctx.floor_bytes * ctx.passes, s, ctx.kind)
