"""setup_s: process start to the start of the measured window (host clock)."""


def read(ctx):
    return ctx["setup_s"]
