"""Phase timers + optional ``torch.profiler`` tracing.

Counterpart of the JAX package's ``utils/timing.py``. ``Timer`` is a
zero-cost-when-disabled context manager used at phase boundaries only, and
when given ``sync_on`` (a tensor, or a device) it waits for that device's
stream at the end of the phase, so device work is attributed to the phase
(the counterpart of ``jax.block_until_ready``). ``trace_context`` wraps a
region in a ``torch.profiler`` trace when a trace directory is given and
writes it there as a Chrome trace (viewable in Perfetto).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


def _synchronize(sync_on) -> None:
    """Wait for the stream of ``sync_on``'s device (a tensor, a device or a
    device name); nothing to wait for on the CPU."""
    device = sync_on.device if isinstance(sync_on, torch.Tensor) else torch.device(sync_on)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Timer:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.times: dict = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync_on=None):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_on is not None:
                _synchronize(sync_on)
            dt = (time.perf_counter() - t0) * 1000.0
            self.times.setdefault(name, []).append(dt)

    def mean_ms(self, name: str) -> float:
        v = self.times.get(name, [])
        return sum(v) / len(v) if v else 0.0


@contextlib.contextmanager
def trace_context(trace_dir: Optional[str]):
    """Profile the region (host, and the card where there is one) and write
    ``trace.json`` into ``trace_dir``; a no-op when ``trace_dir`` is empty."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
