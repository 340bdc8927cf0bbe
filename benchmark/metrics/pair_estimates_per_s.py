"""Requests answered well inside the window ÷ the window's seconds (host
clock): poses returned, or estimates whose pose reached the host. A failed
or invalid answer is counted in ``failed`` and not here."""

from benchmark.harness.readers import rate


def read(ctx):
    return rate(ctx)
