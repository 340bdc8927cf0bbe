"""ctypes binding for the native C++ PNG decode core (``native/rgbd_native.cpp``).

Counterpart of the JAX package's ``data/native_loader.py``: the shared
library ``native/librgbd_native.so`` at the repository root is built on
first use by ``native/Makefile`` (g++ and libpng) and its handle cached;
the same ABI check (``rgbd_version() == 2``). Where the library cannot be built or loaded,
every decode entry point falls back to the standard-library codec of
``data/png.py`` (the reference falls back to OpenCV, which the port does not
need); :func:`decoder_name` says which of the two is in use.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from rgbd_pose_estimation_tpu_torch.data import png

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "librgbd_native.so")

_lock = threading.Lock()
_lib = None
_lib_tried = False


def _load():
    global _lib, _lib_tried
    with _lock:
        if _lib_tried:
            return _lib
        _lib_tried = True
        try:
            src = os.path.join(_NATIVE_DIR, "rgbd_native.cpp")
            stale = not os.path.exists(_LIB_PATH) or (
                os.path.exists(src)
                and os.path.getmtime(src) > os.path.getmtime(_LIB_PATH)
            )
            if stale:
                # Built under a name of this process's own, then renamed into
                # place: two processes building at once never load a
                # half-written library. A failed rebuild (no g++ or libpng
                # headers) leaves a working library in place, and that one
                # is loaded.
                own = f"librgbd_native.{os.getpid()}.so"
                build = subprocess.run(
                    ["make", "-s", "-B", f"TARGET={own}"], cwd=_NATIVE_DIR, capture_output=True
                )
                if build.returncode == 0:
                    os.replace(os.path.join(_NATIVE_DIR, own), _LIB_PATH)
                elif not os.path.exists(_LIB_PATH):
                    raise RuntimeError(build.stderr.decode(errors="replace"))
            lib = ctypes.CDLL(_LIB_PATH)
            lib.rgbd_png_dims.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
            ]
            lib.rgbd_decode_depth16.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_uint16),
                ctypes.c_int64,
            ]
            lib.rgbd_decode_gray8.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int64,
            ]
            lib.rgbd_loader_create.restype = ctypes.c_void_p
            lib.rgbd_loader_create.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.c_int,
                ctypes.c_int,
                ctypes.c_int,
                ctypes.c_int,
                ctypes.c_int,
            ]
            lib.rgbd_loader_next.restype = ctypes.c_int64
            lib.rgbd_loader_next.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_uint16),
            ]
            lib.rgbd_loader_destroy.argtypes = [ctypes.c_void_p]
            lib.rgbd_version.restype = ctypes.c_int
            lib.rgbd_version.argtypes = []
            if lib.rgbd_version() != 2:
                raise RuntimeError("native ABI mismatch")
            _lib = lib
        except (OSError, RuntimeError, AttributeError):
            _lib = None
        return _lib


def native_available() -> bool:
    return _load() is not None


def decoder_name() -> str:
    """``"native"`` (libpng through ``native/``) or ``"stdlib"``
    (``data/png.py``): the decoder that :func:`decode_depth16` and
    :func:`decode_gray8` use."""
    return "native" if native_available() else "stdlib"


def _dims(lib, path: str):
    w = ctypes.c_int()
    h = ctypes.c_int()
    ch = ctypes.c_int()
    bd = ctypes.c_int()
    rc = lib.rgbd_png_dims(
        os.fsencode(path), ctypes.byref(w), ctypes.byref(h), ctypes.byref(ch), ctypes.byref(bd)
    )
    if rc != 0:
        raise IOError(f"rgbd_png_dims({path}) -> {rc}")
    return w.value, h.value, ch.value, bd.value


def png_dims(path: str):
    """(width, height, channels, bit_depth) of a PNG via the native core."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    return _dims(lib, path)


def decode_depth16(path: str) -> np.ndarray:
    """16-bit TUM depth PNG → (H, W) uint16 (native; stdlib codec fallback)."""
    lib = _load()
    if lib is None:
        img = png.read_png(path)
        if img.dtype != np.uint16 or img.ndim != 2:
            raise IOError(f"{path}: not a 16-bit single-channel PNG")
        return img
    w, h, _, _ = _dims(lib, path)
    out = np.empty((h, w), np.uint16)
    rc = lib.rgbd_decode_depth16(
        os.fsencode(path), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), out.size
    )
    if rc != 0:
        raise IOError(f"rgbd_decode_depth16({path}) -> {rc}")
    return out


def decode_gray8(path: str) -> np.ndarray:
    """Any PNG → (H, W) uint8 luma (native; stdlib codec fallback, the same
    luma weights)."""
    lib = _load()
    if lib is None:
        return png.to_gray8(png.read_png(path))
    w, h, _, _ = _dims(lib, path)
    out = np.empty((h, w), np.uint8)
    rc = lib.rgbd_decode_gray8(
        os.fsencode(path), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.size
    )
    if rc != 0:
        raise IOError(f"rgbd_decode_gray8({path}) -> {rc}")
    return out


class NativePrefetcher:
    """Multi-threaded C++ prefetching loader over a (rgb, depth) file list.

    Wraps the native ring-buffer runtime (``rgbd_loader_*``): ``n_threads``
    decode workers fill ``queue_depth`` slots strictly ahead of the
    consumer, off the Python GIL. Iteration yields ``(index, gray uint8
    (H, W), depth uint16 (H, W))`` in sequence order; conversion to
    meters/float stays with the caller.

    Raises at construction if the native library is unavailable — callers
    use :func:`native_available` to pick between this and the Python
    ``data/prefetch.py`` fallback.
    """

    def __init__(
        self,
        rgb_paths,
        depth_paths,
        width: int,
        height: int,
        queue_depth: int = 8,
        n_threads: int = 4,
    ):
        if len(rgb_paths) != len(depth_paths):
            raise ValueError("rgb/depth path lists must align")
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._n = len(rgb_paths)
        self._w, self._h = width, height
        rgb_arr = (ctypes.c_char_p * self._n)(*[os.fsencode(p) for p in rgb_paths])
        dep_arr = (ctypes.c_char_p * self._n)(*[os.fsencode(p) for p in depth_paths])
        self._handle = lib.rgbd_loader_create(
            rgb_arr, dep_arr, self._n, width, height, queue_depth, n_threads
        )
        if not self._handle:
            raise RuntimeError("rgbd_loader_create failed")

    def __len__(self):
        return self._n

    def __iter__(self):
        for _ in range(self._n):
            yield self.next()

    def next(self):
        gray = np.empty((self._h, self._w), np.uint8)
        depth = np.empty((self._h, self._w), np.uint16)
        idx = self._lib.rgbd_loader_next(
            self._handle,
            gray.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            depth.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        )
        if idx < 0:
            raise IOError(f"rgbd_loader_next -> {idx}")
        return int(idx), gray, depth

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.rgbd_loader_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
