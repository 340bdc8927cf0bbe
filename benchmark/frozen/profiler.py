"""Reduction of a profiler trace to device busy time, launches and idle gaps.

Copied from chip_smoke.py at commit 01a5bf9 (``profile_device``,
``device_summary``: kernel time summed by name over one traced call) and
corrected for a steady window: "busy" is the union of the intervals in which
a kernel, a copy or a fill ran on the device, not the sum of their times
(two streams overlapping count once), taken over a traced sub-window of many
requests; the window's length comes from the host clock around it. Gaps
between busy intervals are put down to the host operation that was running
when the gap opened.
"""

from __future__ import annotations

import bisect

_MEMORY_PREFIXES = ("Memcpy", "Memset", "memcpy", "memset")
_SHORT_GAP_NS = 10_000  # gaps shorter than this are summed under one name


def is_memory_op(name: str) -> bool:
    return name.startswith(_MEMORY_PREFIXES)


def union_ns(intervals):
    """Length of the union of ``(start, end)`` intervals, and the gaps
    ``(start, end)`` between its pieces."""
    total, gaps = 0, []
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            total += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total, gaps


def _host_op_at(starts, host, t):
    """Name of the innermost host operation running at time ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 64, -1), -1):
        s, e, name = host[j]
        if e >= t:
            return name
    return "host outside traced operations"


def reduce(device_events, host_events, window_s):
    """``device_events``, ``host_events``: ``(name, start_ns, end_ns)`` of the
    traced sub-window. Returns the summary the per-layer metrics read."""
    by_name = {}
    kernels = 0
    for name, s, e in device_events:
        entry = by_name.setdefault(name, [0, 0])
        entry[0] += 1
        entry[1] += e - s
        if not is_memory_op(name):
            kernels += 1
    busy_ns, gaps = union_ns([(s, e) for _, s, e in device_events])
    # By start, the enclosing operation before the one it encloses.
    host = sorted(((s, e, n) for n, s, e in host_events), key=lambda h: (h[0], -h[1]))
    starts = [h[0] for h in host]
    idle = {}
    for s, e in gaps:
        name = "gaps under 10 us" if e - s < _SHORT_GAP_NS else _host_op_at(starts, host, s)
        idle[name] = idle.get(name, 0) + (e - s)
    ops = sorted(((n, c, ns / 1e9) for n, (c, ns) in by_name.items()), key=lambda r: -r[2])
    return {
        "window_s": window_s,
        "busy_s": busy_ns / 1e9,
        "kernel_launches": kernels,
        "device_ops": [[n, c, s] for n, c, s in ops],
        "idle_gaps": sorted(([n, ns / 1e9] for n, ns in idle.items()), key=lambda r: -r[1]),
    }


def kernel_time(summary, kernel_name):
    """(launches, device seconds) of the kernels whose name holds
    ``kernel_name`` as a word."""
    count, seconds = 0, 0.0
    for name, c, s in summary["device_ops"]:
        if _holds_word(name, kernel_name):
            count += c
            seconds += s
    return count, seconds


def _holds_word(name, word):
    i = name.find(word)
    while i >= 0:
        before = name[i - 1] if i > 0 else " "
        after = name[i + len(word)] if i + len(word) < len(name) else " "
        if not (before.isalnum() or before == "_") and not (after.isalnum() or after == "_"):
            return True
        i = name.find(word, i + 1)
    return False
