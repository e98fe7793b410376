"""Seconds of the program's `chunk_upload` phase timer over the window, per
million rows: a table chunk's copy to the card (its bytes are the
phase's `nbytes`), in the caller for a pass's first chunk and in the
prefetch thread for the others."""


def read(ctx):
    if not ctx.phases or "chunk_upload" not in ctx.phases or not ctx.rows:
        return None
    return ctx.phases["chunk_upload"] / (ctx.rows / 1e6)
