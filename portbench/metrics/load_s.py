"""Seconds of Classifier.load, by the harness's clock around the call."""


def read(ctx):
    return ctx.setup["load_s"]
