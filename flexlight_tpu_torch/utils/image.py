"""Minimal PNG writer (no external deps) for frame output.

The port's own copy of flexlight_tpu/utils/image.py (flexlight_tpu_torch imports
nothing of the JAX package): the same bytes for the same image. Beside it,
png_bytes_parts deflates a frame in row parts on a thread pool (the frame
server's encode): zlib drops the GIL while it compresses."""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import Executor

import numpy as np


def to_uint8(img: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(img) * 255.0 + 0.5, 0, 255).astype(np.uint8)


def png_bytes(img: np.ndarray, level: int = 6) -> bytes:
    """Encode [H, W, 3] float in [0,1] or uint8 as PNG bytes."""
    if img.dtype != np.uint8:
        img = to_uint8(img)
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(raw, level)) + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    """img: [H, W, 3] float in [0,1] or uint8."""
    with open(path, "wb") as f:
        f.write(png_bytes(img))


MAX_PNG_PARTS = 16      # the most row parts (and pool threads) a frame takes
MIN_PART_ROWS = 64      # the fewest rows a part takes: small frames stay whole


def png_parts(height: int) -> int:
    """Row parts for png_bytes_parts: one per CPU this process may run on
    less one (the caller's thread), at most MAX_PNG_PARTS, and at least
    MIN_PART_ROWS rows a part; 1 for a frame too small to split."""
    cpus = len(os.sched_getaffinity(0))
    return max(1, min(cpus - 1, MAX_PNG_PARTS, height // MIN_PART_ROWS))


_IDAT_CRC = zlib.crc32(b"IDAT")


def _deflate_part(rows, level: int, head: bytes, last: bool):
    """One IDAT body (a raw deflate of `rows` after `head`, ended by a full
    flush, or by the end of the stream where `last`) and the chunk's crc32
    so far."""
    c = zlib.compressobj(level, zlib.DEFLATED, -15)
    body = head + c.compress(rows) + c.flush(zlib.Z_FINISH if last else zlib.Z_FULL_FLUSH)
    return body, zlib.crc32(body, _IDAT_CRC)


def png_bytes_parts(img: np.ndarray, parts: int, pool: Executor, level: int = 1) -> bytes:
    """png_bytes(img, level) with its zlib stream deflated in `parts`
    contiguous row parts on `pool`, each part its own IDAT. The parts join
    into one zlib stream: the first carries the header, each but the last
    ends in a full flush, the adler32 of the whole stream follows the last.
    The same filter (0 on every row), level and PNG type; with one part,
    png_bytes's exact bytes."""
    if img.dtype != np.uint8:
        img = to_uint8(img)
    h, w = img.shape[:2]
    rows = np.empty((h, 1 + 3 * w), np.uint8)
    rows[:, 0] = 0
    rows[:, 1:] = img.reshape(h, 3 * w)
    stream, stride = memoryview(rows.reshape(-1)), rows.shape[1]
    cuts = [h * i // parts * stride for i in range(parts + 1)]
    heads = [zlib.compress(b"", level)[:2]] + [b""] * (parts - 1)  # the zlib header
    futures = [pool.submit(_deflate_part, stream[a:b], level, head, i == parts - 1)
               for i, (a, b, head) in enumerate(zip(cuts, cuts[1:], heads))]
    adler = struct.pack(">I", zlib.adler32(stream))     # here, while the parts deflate
    out = [b"\x89PNG\r\n\x1a\n", _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))]
    for i, future in enumerate(futures):
        body, crc = future.result()
        tail = adler if i == parts - 1 else b""
        out += [struct.pack(">I", len(body) + len(tail)), b"IDAT", body, tail,
                struct.pack(">I", zlib.crc32(tail, crc) & 0xFFFFFFFF)]
    out.append(_chunk(b"IEND", b""))
    return b"".join(out)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))
