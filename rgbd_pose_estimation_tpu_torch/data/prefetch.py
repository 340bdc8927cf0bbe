"""Host-side prefetching data pipeline.

Counterpart of the JAX package's ``data/prefetch.py``. A background thread
decodes frame i+1 (PNG decode and float conversion are host work) while the
device tracks frame i, through a bounded queue, so the producer never runs
ahead without bound: one producer, one consumer.

Where frames go to the device ahead of use (``device_depth=True``), they are
copied from pinned host memory with ``non_blocking=True`` onto the caller's
``device``: nothing on the producer's side waits for the stream, and the
only read-back is the consumer's own.
"""

from __future__ import annotations

import os
import queue
import threading

import numpy as np
import torch


class PrefetchIterator:
    """Wrap ``loader(i) -> item`` for i in [0, n) with bounded lookahead."""

    def __init__(self, loader, n: int, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._n = n
        self._error = None

        def worker():
            try:
                for i in range(n):
                    self._q.put(loader(i))
            except BaseException as e:  # surfaced on the consumer side
                self._error = e
                self._q.put(None)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        for _ in range(self._n):
            item = self._q.get()
            if item is None and self._error is not None:
                raise self._error
            yield item


def background_iter(gen, depth: int = 2):
    """Drain ``gen`` in a daemon thread through a bounded queue (one
    producer, one consumer); overlaps host→device copies with the
    consumer's work."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    done = object()
    err = []

    def worker():
        try:
            for item in gen:
                q.put(item)
        except BaseException as e:
            err.append(e)
        q.put(done)

    threading.Thread(target=worker, daemon=True).start()

    def out():
        while True:
            item = q.get()
            if item is done:
                if err:
                    raise err[0]
                return
            yield item

    return out()


def _to_device(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array → ``device``; to a CUDA device through pinned memory by a
    non-blocking copy (the pinned block is not reused before the copy ends)."""
    t = torch.from_numpy(np.ascontiguousarray(host))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def sequence_prefetcher(
    seq, start: int, n: int, n_threads: int = 4, device_depth: bool = False,
    device="cuda",
):
    """Best prefetching iterator for ``seq``: yields ``(ts, gray, depth)``.

    PNG-backed sequences (TUM, ICL's TUM-compatible release) stream through
    the native C++ decode pool (``native_loader.NativePrefetcher``: parallel
    inflate off the GIL), with the float conversion here on the consumer's
    side. Anything else (raw ICL text depth, no native library, other PNG
    formats) takes the single-thread :class:`PrefetchIterator` over
    ``seq.frame``; both yield the same values.

    ``device_depth=True`` also ships each depth to ``device`` from the
    prefetch thread, ahead of use, and yields it as a tensor there: raw
    uint16 for PNG sequences (half the bytes; ``seq.depth_scale`` turns it
    into metres on the device, as ``DenseOdometry`` does), float32 metres
    otherwise. ``device`` is used only then.
    """
    from rgbd_pose_estimation_tpu_torch.data import native_loader as nl

    device = torch.device(device)

    def _fallback():
        base = PrefetchIterator(lambda i: seq.frame(start + i), n)
        if not device_depth:
            return base
        return background_iter(
            (ts, gray, _to_device(depth, device)) for ts, gray, depth in base
        )

    rgb_files = getattr(seq, "rgb_files", None)
    depth_files = getattr(seq, "depth_files", None)
    root = getattr(seq, "root", None)
    scale = getattr(seq, "depth_scale", None)
    if (
        rgb_files is None
        or depth_files is None
        or scale is None
        or not nl.native_available()
        or not str(depth_files[start]).endswith(".png")
    ):
        return _fallback()

    rgb = [os.path.join(root, f) for f in rgb_files[start : start + n]]
    dep = [os.path.join(root, f) for f in depth_files[start : start + n]]
    try:
        w, h, ch, bd = nl.png_dims(dep[0])
        if (ch, bd) != (1, 16) or nl.png_dims(rgb[0])[:2] != (w, h):
            return _fallback()
        pf = nl.NativePrefetcher(rgb, dep, w, h, n_threads=n_threads)
    except (IOError, RuntimeError):
        return _fallback()

    ts = seq.timestamps

    if device_depth:

        def _gen_dev():
            # Several frames a host→device copy: the copy's set-up cost
            # dominates at these sizes, and a slice on the device is free.
            B = 4
            with pf:
                buf = []
                for i, gray_u8, depth_u16 in pf:
                    buf.append((float(ts[start + i]), gray_u8.astype(np.float32) / 255.0, depth_u16))
                    if len(buf) == B or i == n - 1:
                        stack = _to_device(np.stack([b[2] for b in buf]), device)
                        for k, (t, g, _) in enumerate(buf):
                            yield (t, g, stack[k])
                        buf = []

        return background_iter(_gen_dev())

    def _gen():
        with pf:
            for i, gray_u8, depth_u16 in pf:
                yield (
                    float(ts[start + i]),
                    gray_u8.astype(np.float32) / 255.0,
                    depth_u16.astype(np.float32) * scale,
                )

    return _gen()
