"""A PNG reader on zlib and numpy, for colour-raster maps.

It reads what map rasters are written as: 8-bit RGB or RGBA,
non-interlaced, with any of the five scanline filters (none, sub, up,
average, Paeth).  Any other PNG (palette, grey, 16-bit, interlaced, a
bad CRC) raises ValueError naming what it found; there is no fallback to
another reader.

The average and Paeth filters predict each byte from its reconstructed
left, upper and upper-left neighbours, so a row cannot be reconstructed
before its left part, nor before the row above.  Every pixel on one
anti-diagonal (row + column constant) depends only on the two diagonals
before it, so the reconstruction walks the H + W - 1 diagonals and treats
each one as a vector.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> bytes per pixel at bit depth 8
_CHANNELS = {2: 3, 6: 4}
_COLOUR_NAMES = {0: "greyscale", 3: "palette", 4: "greyscale with alpha"}


def _chunks(data: bytes):
    """(type, payload) of each chunk, CRCs checked, up to IEND."""
    pos = len(SIGNATURE)
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError("truncated PNG chunk")
        payload = data[pos + 8:end]
        (crc,) = struct.unpack(">I", data[end:end + 4])
        if zlib.crc32(kind + payload) & 0xFFFFFFFF != crc:
            raise ValueError(f"bad CRC in PNG chunk {kind!r}")
        yield kind, payload
        if kind == b"IEND":
            return
        pos = end + 4
    raise ValueError("PNG without IEND")


def _unfilter(rows: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """Reconstruct (h, w, bpp) uint8 pixels from the filtered scanlines
    rows (h, 1 + w * bpp): a filter-type byte, then the row's bytes."""
    ftype = rows[:, 0].astype(np.int16)
    if ftype.max(initial=0) > 4:
        raise ValueError(f"unknown PNG scanline filter {int(ftype.max())}")
    filt = rows[:, 1:].reshape(h, w, bpp).astype(np.int16)
    n_diag = h + w - 1
    r = np.arange(h)[:, None]
    x = np.arange(w)[None, :]
    # skewed layouts: diagonal d = r + x is column d of fs, column d + 2
    # of rec; rec's row 0 and columns 0-1 are the zeros outside the image
    fs = np.zeros((h, n_diag, bpp), np.int16)
    fs[r, r + x] = filt
    rec = np.zeros((h + 1, n_diag + 2, bpp), np.int16)
    t = ftype[:, None]
    for d in range(n_diag):
        lo, hi = max(0, d - w + 1), min(h - 1, d) + 1
        a = rec[lo + 1:hi + 1, d + 1]  # left
        b = rec[lo:hi, d + 1]  # up
        c = rec[lo:hi, d]  # upper left
        tt = t[lo:hi]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        pred = np.select([tt == 1, tt == 2, tt == 3, tt == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        rec[lo + 1:hi + 1, d + 2] = (fs[lo:hi, d] + pred) & 255
    return rec[r + 1, r + x + 2].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """The pixels of an 8-bit RGB or RGBA non-interlaced PNG, (H, W, 3) or
    (H, W, 4) uint8, row 0 at the top."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, colour, compression, filter_method, interlace = header
    if colour not in _CHANNELS:
        name = _COLOUR_NAMES.get(colour, f"colour type {colour}")
        raise ValueError(f"{path}: {name} PNG; only 8-bit RGB and RGBA "
                         "are read")
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit PNG; only 8-bit RGB and "
                         "RGBA are read")
    if interlace != 0:
        raise ValueError(f"{path}: interlaced PNG; only non-interlaced "
                         "PNGs are read")
    if compression != 0 or filter_method != 0:
        raise ValueError(f"{path}: unknown PNG compression or filter method")
    bpp = _CHANNELS[colour]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise ValueError(f"{path}: {raw.size} bytes of image data for "
                         f"{w} x {h} x {bpp}")
    return _unfilter(raw.reshape(h, 1 + w * bpp), h, w, bpp)


def read_png_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB of an 8-bit RGB or RGBA PNG; an alpha channel
    is dropped, as PIL's convert("RGB") drops it."""
    return np.ascontiguousarray(read_png(path)[..., :3])
