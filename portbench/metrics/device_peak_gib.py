"""torch.cuda.max_memory_allocated() over the build, the load, the warm-up
and the window, in GiB (the peak is reset once the harness has made its
inputs)."""


def read(ctx):
    return None if ctx.peak_bytes is None else ctx.peak_bytes / 2**30
