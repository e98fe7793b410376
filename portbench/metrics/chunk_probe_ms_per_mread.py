"""Milliseconds of device time of K7, the out-of-core chunk probe's three
kernels (`chunk_count_kernel`, `chunk_scatter_kernel`,
`chunk_probe_kernel`), in the window's trace, per million rows.  The
trace's summary keeps the device operations that took most time; where
any of the three is not among them, this reads nothing rather than a
part of K7's time."""

KERNELS = ("chunk_count_kernel", "chunk_scatter_kernel",
           "chunk_probe_kernel")


def _kernel(name: str) -> str:
    """A device operation's kernel name, without its return type, template
    arguments and parameters."""
    return name.removeprefix("void ").split("(")[0].split("<")[0].strip()


def seconds(ctx):
    """K7's device seconds in the window, or None where the trace lacks
    any of its kernels."""
    if not ctx.trace:
        return None
    found = {}
    for name, s in ctx.trace.get("device_ops", []):
        base = _kernel(name)
        if base in KERNELS:
            found[base] = found.get(base, 0.0) + s
    if len(found) < len(KERNELS):
        return None
    return sum(found.values())


def read(ctx):
    s = seconds(ctx)
    if s is None or not ctx.rows:
        return None
    return s * 1e3 / (ctx.rows / 1e6)
