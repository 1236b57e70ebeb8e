"""PNG reader and writer on the standard library's ``zlib`` and numpy.

The port's own decoder for what the reference reads through PIL (TUM depth
and color, ScanNet depth and instance images) and its encoder for the
fixtures and renders it writes.  It reads non-interlaced gray, gray+alpha,
RGB and RGBA images of 8 or 16 bits per sample, with all five scanline
filters, and writes 8-bit gray, RGB and RGBA and 16-bit gray with filter 0.
Palette and interlaced images, and bit depths below 8, raise ``ValueError``.

Speed: filters None, Sub and Up are vectorized over a row; Average and
Paeth depend on the decoded left neighbour and run a Python loop over the
row's bytes, which is slow (seconds for a 640x480 RGB image) but exact.
Images this package writes use filter 0 only.  The native loader
(``datasets/native_loader.py``, libpng) is the fast path for sequences.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Channels of each supported color type: gray, RGB, gray+alpha, RGBA.
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunks(data: bytes):
    """(type, payload) of each chunk, CRC checked."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError(f"truncated PNG chunk {kind!r}")
        payload = data[pos + 8:end]
        (crc,) = struct.unpack(">I", data[end:end + 4])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, payload
        if kind == b"IEND":
            return
        pos = end + 4
    raise ValueError("PNG file has no IEND chunk")


def read_header(path: str) -> tuple[int, int]:
    """(width, height) from a PNG's IHDR chunk, without decoding pixels."""
    with open(path, "rb") as f:
        head = f.read(33)
    if head[:8] != SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"not a PNG file: {path}")
    return struct.unpack(">II", head[16:24])


def _unfilter_slow(kind: int, row: bytearray, prev: bytes, bpp: int) -> None:
    """Average (3) or Paeth (4) reconstruction of one row, in place."""
    for i in range(len(row)):
        a = row[i - bpp] if i >= bpp else 0
        b = prev[i]
        if kind == 3:
            row[i] = (row[i] + ((a + b) >> 1)) & 0xFF
            continue
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        row[i] = (row[i] + pred) & 0xFF


def decode(data: bytes) -> np.ndarray:
    """Pixels of a PNG file's bytes: uint8 or uint16 (native byte order),
    shaped (H, W) for gray and (H, W, C) otherwise."""
    header, idat = None, []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError("PNG file has no IHDR chunk")
    w, h, bits, color, _, _, interlace = header
    if color not in _CHANNELS or bits not in (8, 16) or interlace != 0:
        raise ValueError(f"unsupported PNG: color type {color}, {bits} bits, "
                         f"interlace {interlace}")
    ch = _CHANNELS[color]
    bpp = ch * bits // 8  # bytes per pixel, the filters' unit
    stride = w * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < h * (stride + 1):
        raise ValueError("PNG image data is shorter than its header says")
    rows = np.frombuffer(raw, np.uint8, count=h * (stride + 1)).reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, cur = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            out[y] = cur
        elif kind == 1:  # Sub: a running sum along each byte lane of a pixel
            out[y] = np.cumsum(cur.reshape(w, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            out[y] = cur + prev
        elif kind in (3, 4):
            row = bytearray(cur.tobytes())
            _unfilter_slow(kind, row, prev.tobytes(), bpp)
            out[y] = np.frombuffer(bytes(row), np.uint8)
        else:
            raise ValueError(f"PNG row {y} has unknown filter type {kind}")
        prev = out[y]
    if bits == 16:
        pixels = out.view(">u2").astype(np.uint16)
    else:
        pixels = out
    return pixels.reshape(h, w) if ch == 1 else pixels.reshape(h, w, ch)


def read(path: str) -> np.ndarray:
    """Decode the PNG file at `path` (see ``decode``)."""
    with open(path, "rb") as f:
        return decode(f.read())


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def encode(image: np.ndarray) -> bytes:
    """PNG bytes of a uint8 (H, W), (H, W, 3) or (H, W, 4) image, or a uint16
    (H, W) image; every row with filter 0."""
    image = np.asarray(image)
    if image.dtype == np.uint8 and image.ndim == 2:
        color, ch = 0, 1
    elif image.dtype == np.uint8 and image.ndim == 3 and image.shape[2] in (3, 4):
        color, ch = (2 if image.shape[2] == 3 else 6), image.shape[2]
    elif image.dtype == np.uint16 and image.ndim == 2:
        color, ch = 0, 1
    else:
        raise ValueError(f"cannot write a PNG of dtype {image.dtype} and shape {image.shape}")
    h, w = image.shape[:2]
    bits = 8 * image.dtype.itemsize
    body = image.astype(">u2") if bits == 16 else image
    rows = np.empty((h, 1 + w * ch * image.dtype.itemsize), np.uint8)
    rows[:, 0] = 0
    rows[:, 1:] = np.ascontiguousarray(body).view(np.uint8).reshape(h, -1)
    ihdr = struct.pack(">IIBBBBB", w, h, bits, color, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _chunk(b"IEND", b""))


def write(path: str, image: np.ndarray) -> None:
    """Write `image` to `path` as a PNG (see ``encode``)."""
    with open(path, "wb") as f:
        f.write(encode(image))
