"""Seconds of the program's `merge` phase timer over the window, per
million rows: each chunk of the paired FASTQ merge
(`io.fasta.merge_paired`)."""


def read(ctx):
    if not ctx.phases or "merge" not in ctx.phases or not ctx.rows:
        return None
    return ctx.phases["merge"] / (ctx.rows / 1e6)
