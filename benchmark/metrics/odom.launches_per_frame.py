"""Kernels that ran on the card in the traced sub-window ÷ the requests
served in it (profiler events; copies and fills are not counted)."""

from benchmark.harness.readers import launches_per_request


def read(ctx):
    return launches_per_request(ctx)
