"""Decode the PNGs the frame server sends (utils/image.py png_bytes:
8-bit RGB, not interlaced, every row filter 0), with zlib and numpy."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def decode(data: bytes) -> np.ndarray:
    """PNG bytes -> [H, W, 3] uint8."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = header
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), dtype=np.uint8).reshape(h, 1 + 3 * w)
    if (depth, ctype, interlace) != (8, 2, 0) or rows[:, 0].any():
        raise ValueError("not a frame of the frame server: 8-bit RGB rows of filter 0 only")
    return rows[:, 1:].reshape(h, w, 3).copy()
