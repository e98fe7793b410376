"""Seconds of build_database, by the harness's clock around the call."""


def read(ctx):
    return ctx.setup["db_build_s"]
