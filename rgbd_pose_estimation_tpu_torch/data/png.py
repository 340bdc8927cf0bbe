"""A small PNG codec on the standard library (``zlib`` + ``struct``) and numpy.

The port's counterpart of the JAX package's OpenCV fallback in
``data/native_loader.py``: where the native decoder (``native/``, libpng)
cannot be built, frames are decoded here, and the synthetic writers encode
here, so the port needs neither OpenCV nor libpng.

What it reads: non-interlaced 8- and 16-bit gray, gray+alpha, RGB and RGBA
(colour types 0, 4, 2, 6), every filter type; this covers TUM and ICL-NUIM.
Palette images, bit depths below 8 and Adam7 interlacing raise
``ValueError``. What it writes: 8- or 16-bit gray and 8-bit RGB, every row
with filter type 0.

Rows filtered with Average or Paeth depend on their left and upper
neighbours, so the unfiltering runs over anti-diagonals of the pixel grid
(every pixel of one diagonal at once, ``H + W - 1`` steps); images whose
rows are all unfiltered skip that.

``to_gray8`` converts as the native core does (``native/rgbd_native.cpp``,
``rgbd_decode_gray8``): 16-bit samples keep their high byte, alpha is
dropped, RGB becomes ``(77 R + 150 G + 29 B) >> 8``. The JAX package's
OpenCV fallback uses OpenCV's own BT.601 rounding instead; the two agree
exactly where R = G = B, which is what the synthetic writers produce.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples a pixel


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length : pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG file ends before IEND")


def _header(body: bytes):
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB", body)
    if ctype not in _CHANNELS or depth not in (8, 16):
        raise ValueError(f"unsupported PNG: colour type {ctype}, bit depth {depth}")
    if comp != 0 or filt != 0:
        raise ValueError("unsupported PNG compression or filter method")
    if interlace != 0:
        raise ValueError("interlaced PNG is not supported")
    return w, h, depth, _CHANNELS[ctype]


def _unfilter(raw: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """``raw`` (h, 1 + w * bpp) filtered scanlines → (h, w, bpp) bytes."""
    ftype = raw[:, 0]
    if ftype.max(initial=0) > 4:
        raise ValueError("PNG row with an unknown filter type")
    f = raw[:, 1:].reshape(h, w, bpp)
    if not ftype.any():
        return np.ascontiguousarray(f)
    # Pixel (r, c) lives at flat index (r+1)(w+1) + (c+1) of a grid with a
    # zero row above and a zero column to the left: its left, upper and
    # upper-left neighbours sit 1, w+1 and w+2 before it, and one
    # anti-diagonal r + c = d is a slice of step w.
    grid = np.zeros(((h + 1) * (w + 1), bpp), np.int16)
    filt = np.zeros_like(grid)
    filt.reshape(h + 1, w + 1, bpp)[1:, 1:] = f
    for d in range(h + w - 1):
        r0, r1 = max(0, d - w + 1), min(h - 1, d)
        start = (r0 + 1) * (w + 1) + (d - r0 + 1)
        stop = (r1 + 1) * (w + 1) + (d - r1 + 1) + 1
        cur = slice(start, stop, w)
        a = grid[start - 1 : stop - 1 : w]
        b = grid[start - w - 1 : stop - w - 1 : w]
        c = grid[start - w - 2 : stop - w - 2 : w]
        kind = ftype[r0 : r1 + 1, None]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select(
            [kind == 1, kind == 2, kind == 3, kind == 4],
            [a, b, (a + b) >> 1, paeth],
            0,
        )
        grid[cur] = (filt[cur] + pred) & 0xFF
    return grid.reshape(h + 1, w + 1, bpp)[1:, 1:].astype(np.uint8)


def decode_png_bytes(data: bytes) -> np.ndarray:
    """PNG bytes → ``(H, W)`` or ``(H, W, C)`` uint8 / uint16 (native byte
    order)."""
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = _header(body)
        elif header is None:
            raise ValueError("PNG whose first chunk is not IHDR")
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ch = header
    bpp = ch * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise ValueError("PNG image data has the wrong size")
    px = _unfilter(raw.reshape(h, 1 + w * bpp), h, w, bpp)
    if depth == 16:
        px = px.reshape(h, w * ch, 2).copy().view(">u2").reshape(h, w, ch).astype(np.uint16)
    return px[..., 0] if ch == 1 else px


def read_png(path) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png_bytes(f.read())


def to_gray8(img: np.ndarray) -> np.ndarray:
    """Decoded image → ``(H, W)`` uint8 luma, as the native core makes it."""
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        return img
    if img.shape[-1] in (2, 4):  # drop alpha
        img = img[..., :-1]
    if img.shape[-1] == 1:
        return np.ascontiguousarray(img[..., 0])
    r, g, b = (img[..., k].astype(np.uint32) for k in range(3))
    return ((77 * r + 150 * g + 29 * b) >> 8).astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def encode_png(img: np.ndarray) -> bytes:
    """``(H, W)`` uint8/uint16 gray or ``(H, W, 3)`` uint8 RGB → PNG bytes."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16) or not (
        img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3 and img.dtype == np.uint8)
    ):
        raise ValueError(f"cannot encode a {img.dtype} array of shape {img.shape}")
    h, w = img.shape[:2]
    depth = 16 if img.dtype == np.uint16 else 8
    ctype = 0 if img.ndim == 2 else 2
    rows = img.astype(">u2") if depth == 16 else img
    rows = np.ascontiguousarray(rows).view(np.uint8).reshape(h, -1)
    scan = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    return (
        _SIGNATURE
        + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(scan.tobytes()))
        + _chunk(b"IEND", b"")
    )


def write_png(path, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))
