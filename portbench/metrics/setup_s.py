"""Seconds from the harness's first line to the first timed pass: torch's
import, the inputs, the database build, the load and the warm-up."""


def read(ctx):
    return ctx.setup["setup_s"]
