"""Byte/float packing helpers.

The port's own copy of flexlight_tpu/utils/glpack.py (flexlight_tpu_torch imports
nothing of the JAX package).

Ports of the reference's GLLib texture-channel packers (gllib.js:82-90)
and the manual float32->float16 bit converter (arrays.js:25-66). The
renderer itself keeps fp32 end to end; these exist for data-interchange
parity with tools built against the reference.
"""

from __future__ import annotations

import numpy as np


def to_float(bytes4) -> float:
    """4 texture channels -> float in [-255, 255] (gllib.js:82)."""
    b = np.asarray(bytes4, dtype=np.float64)
    return float((b[0] + b[1] / 255.0 + b[2] / 65025.0 + b[3] / 16581375.0) * 2.0 - 255.0)


def to_bytes(num: float) -> np.ndarray:
    """float -> 4 texture channels (gllib.js:85-90)."""
    f = (num + 255.0) / 2.0
    vals = np.array([f, f * 255.0, f * 65025.0, f * 16581375.0])
    return np.floor(np.mod(vals, 255.0)).astype(np.int32)


def float32_to_float16_bits(values) -> np.ndarray:
    """float32 -> IEEE 754 half bit patterns as uint16 (arrays.js:28-64)."""
    return np.asarray(values, dtype=np.float32).astype(np.float16).view(np.uint16)


def float16_bits_to_float32(bits) -> np.ndarray:
    return np.asarray(bits, dtype=np.uint16).view(np.float16).astype(np.float32)
