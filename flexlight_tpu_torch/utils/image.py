"""Minimal PNG writer (no external deps) for frame output.

The port's own copy of flexlight_tpu/utils/image.py (flexlight_tpu_torch imports
nothing of the JAX package): the same bytes for the same image."""

from __future__ import annotations

import struct
import zlib

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
