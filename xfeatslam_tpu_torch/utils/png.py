"""A PNG decoder and writer in numpy and ``zlib``, for hosts without
``cv2``.

Reads the images of the datasets the examples take: 8-bit gray, 8-bit RGB
and RGBA, and 16-bit gray (TUM depth), non-interlaced, with any of the
five scanline filters and the image data split over any number of IDAT
chunks. Interlaced and palette images raise ``ValueError``.

``read_gray`` converts as ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` does
through libpng: RGB to gray with libpng's fixed-point weights
(9797, 19234, 3737) / 32768, truncated, a pixel with r == g == b kept as
it is; alpha dropped; 16 bits to 8 by the high byte. ``read`` returns the
samples as stored (RGB order, uint16 for 16-bit), as
``cv2.IMREAD_UNCHANGED`` does for gray images.

``write`` stores 8-bit gray or RGB and 16-bit gray (the TUM depth format),
every row unfiltered, the image data in one IDAT chunk.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> samples per pixel (0 gray, 2 RGB, 6 RGBA)
_CHANNELS = {0: 1, 2: 3, 6: 4}
# libpng's png_set_rgb_to_gray(0.299, 0.587) weights, in 1/32768
_GRAY_WEIGHTS = (9797, 19234, 3737)


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("PNG file ends before its IEND chunk")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int):
    """Undo the scanline filters: ``raw`` holds ``height`` rows of a filter
    byte and ``stride`` bytes. Returns (height, stride) uint8."""
    rows = raw.reshape(height, stride + 1)
    kinds, f = rows[:, 0], rows[:, 1:].astype(np.int32)
    if kinds.max(initial=0) > 4:
        raise ValueError(f"PNG filter type {int(kinds.max())} is unknown")
    out = np.zeros((height + 1, stride + bpp), np.int32)  # zero row and pad
    if not np.isin(kinds, (3, 4)).any():
        # None, Sub and Up: a row at a time (Sub is a running sum per byte
        # of the pixel)
        for y in range(height):
            k = kinds[y]
            row = f[y] + (out[y, bpp:] if k == 2 else 0)
            if k == 1:
                row = np.cumsum(row.reshape(-1, bpp), 0).reshape(-1)
            out[y + 1, bpp:] = row & 0xFF
        return out[1:, bpp:].astype(np.uint8)
    # Average and Paeth read the reconstructed left, up and up-left bytes:
    # pixel (y, x) depends on (y, x-1), (y-1, x) and (y-1, x-1) only, so
    # every pixel of an anti-diagonal y + x = d is done at once
    w = stride // bpp
    f = f.reshape(height, w, bpp)
    rec = out.reshape(height + 1, w + 1, bpp)  # rec[y+1, x+1] is pixel (y, x)
    for d in range(height + w - 1):
        ys = np.arange(max(0, d - w + 1), min(height - 1, d) + 1)
        xs = d - ys
        a, b, c = rec[ys + 1, xs], rec[ys, xs + 1], rec[ys, xs]
        k = kinds[ys][:, None]
        pred = np.select([k == 1, k == 2, k == 3, k == 4],
                         [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)
        rec[ys + 1, xs + 1] = (f[ys, xs] + pred) & 0xFF
    return rec[1:, 1:].reshape(height, stride).astype(np.uint8)


def decode(data: bytes) -> np.ndarray:
    """The samples of a PNG file's bytes: (H, W) for gray, (H, W, C)
    otherwise, in the file's channel order; uint8, or uint16 for 16-bit
    images."""
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG file without an IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    if interlace:
        raise ValueError("interlaced PNG images are not supported")
    if color not in _CHANNELS:
        raise ValueError(f"PNG color type {color} (palette or gray with "
                         "alpha) is not supported")
    if depth not in (8, 16):
        raise ValueError(f"PNG bit depth {depth} is not supported")
    channels = _CHANNELS[color]
    bpp = channels * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (width * bpp + 1):
        raise ValueError("PNG image data has the wrong size")
    px = _unfilter(raw, height, width * bpp, bpp)
    if depth == 16:
        px = px.view(">u2").astype(np.uint16)
    px = px.reshape(height, width, channels)
    return px[..., 0] if channels == 1 else px


def read(path: str) -> np.ndarray:
    """The samples of the PNG file at ``path`` (see ``decode``)."""
    with open(path, "rb") as f:
        return decode(f.read())


def to_gray(px: np.ndarray) -> np.ndarray:
    """uint8 gray from decoded samples, as libpng gives
    ``cv2.IMREAD_GRAYSCALE``."""
    if px.dtype == np.uint16:
        px = (px >> 8).astype(np.uint8)
    if px.ndim == 2:
        return px
    r, g, b = (px[..., k].astype(np.uint32) for k in range(3))
    wr, wg, wb = _GRAY_WEIGHTS
    gray = ((wr * r + wg * g + wb * b) >> 15).astype(np.uint8)
    return np.where((r == g) & (r == b), px[..., 0], gray)


def read_gray(path: str) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` for a PNG file."""
    return to_gray(read(path))


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode(px: np.ndarray) -> bytes:
    """The PNG file of ``px``: (H, W) uint8 or uint16 gray, or (H, W, 3)
    uint8 RGB."""
    px = np.asarray(px)
    if px.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG samples must be uint8 or uint16, not {px.dtype}")
    if px.ndim == 3 and px.shape[2] == 3 and px.dtype == np.uint8:
        color = 2
    elif px.ndim == 2:
        color = 0
    else:
        raise ValueError(f"PNG image of shape {px.shape} and {px.dtype}: "
                         "gray (H, W) or 8-bit RGB (H, W, 3)")
    h, w = px.shape[:2]
    rows = px.astype(">u2") if px.dtype == np.uint16 else px
    rows = np.ascontiguousarray(rows).view(np.uint8).reshape(h, -1)
    # filter type 0 (None) on every row
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], 1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8 * px.dtype.itemsize, color, 0, 0,
                       0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write(path: str, px: np.ndarray) -> None:
    """Write ``px`` (see ``encode``) as a PNG file at ``path``."""
    data = encode(px)
    with open(path, "wb") as f:
        f.write(data)
