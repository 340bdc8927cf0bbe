"""1 − (union of the intervals in which a kernel, a copy or a fill ran on
the card) ÷ the traced sub-window's length, in %."""

from benchmark.harness.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
