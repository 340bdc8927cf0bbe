"""Arithmetic the metric readers share: a window's rate and tail, a traced
sub-window's launches, idle share and kernel rooflines."""

from __future__ import annotations

import statistics

from benchmark.frozen import profiler


def completed(ctx) -> list:
    """Requests answered, and answered well, inside the window."""
    return [r for r in ctx["records"] if r["ok"] and r["t_done"] is not None and r["t_done"] <= ctx["t_end"]]


def rate(ctx) -> float:
    """Requests completed in the window ÷ the window's seconds."""
    return len(completed(ctx)) / ctx["seconds"]


def p95_ms(ctx):
    """95th percentile (ms) of the latencies of the window's completed
    requests; None below 20 requests (fewer than one beyond it)."""
    lat = [(r["t_done"] - r["t_start"]) * 1e3 for r in completed(ctx)]
    if len(lat) < 20:
        return None
    return statistics.quantiles(lat, n=20, method="inclusive")[18]


def device_trace(ctx):
    """The traced sub-window's summary, or None where nothing ran on a card."""
    s = ctx["trace"]
    if s is None or s["kernel_launches"] == 0:
        return None
    return s


def launches_per_request(ctx):
    s = device_trace(ctx)
    return None if s is None else s["kernel_launches"] / s["requests"]


def idle_pct(ctx):
    s = device_trace(ctx)
    return None if s is None else 100.0 * (1.0 - s["busy_s"] / s["window_s"])


def roofline_pct(ctx, kernel: str, bound_s_per_call: float):
    """Σ bound time ÷ Σ device time of ``kernel``'s launches, in %; None
    where it did not run."""
    s = device_trace(ctx)
    if s is None:
        return None
    count, seconds = profiler.kernel_time(s, kernel)
    if count == 0 or seconds <= 0:
        return None
    return 100.0 * count * bound_s_per_call / seconds
