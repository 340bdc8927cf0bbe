"""95th percentile of the latency of the window's completed requests, on
the benchmark's clock: a frame from the moment the server pulls it to the
moment its pose is yielded; an estimate from the call to its pose on the
host."""

from benchmark.harness.readers import p95_ms


def read(ctx):
    return p95_ms(ctx)
