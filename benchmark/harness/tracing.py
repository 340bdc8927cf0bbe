"""The traced sub-window: ``torch.profiler`` on the host and the card over a
fixed number of requests, reduced to a compact summary."""

from __future__ import annotations

import time

import torch

from benchmark.frozen import profiler


class TracedWindow:
    """Opens after ``skip`` completed requests and closes after ``skip + n``;
    pass :meth:`on_complete` to a client's ``serve``."""

    def __init__(self, skip: int, n: int):
        self.skip, self.n = skip, n
        self.prof = None
        self.t0 = self.t1 = None
        self.summary = None

    def on_complete(self, done: int) -> bool:
        if done == self.skip:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                torch.cuda.synchronize()
                activities.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=activities)
            self.prof.start()
            self.t0 = time.perf_counter()
        elif done == self.skip + self.n and self.prof is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.t1 = time.perf_counter()
            self.prof.stop()
            return True
        return False

    def reduce(self):
        """The summary of :func:`benchmark.frozen.profiler.reduce`, or None
        where the window never closed."""
        if self.t1 is None:
            return None
        device, host = [], []
        for ev in self.prof.profiler.kineto_results.events():
            s = ev.start_ns()
            item = (ev.name(), s, s + ev.duration_ns())
            if ev.device_type() == torch.autograd.DeviceType.CUDA:
                device.append(item)
            else:
                host.append(item)
        self.summary = profiler.reduce(device, host, self.t1 - self.t0)
        self.summary["requests"] = self.n
        return self.summary
