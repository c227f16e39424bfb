"""SoA 3-vector helpers for the wavefront shading path.

A vector batch is a tuple ``(x, y, z)`` of [N] float32 tensors, the layout
of flexlight_tpu/ops/vec3.py. Every helper spells out its arithmetic in
the same order as that module, so both packages round alike.
"""

from __future__ import annotations

import torch

V3 = tuple  # (x, y, z) of [N] tensors


def stack3(v) -> torch.Tensor:
    return torch.stack(v, dim=-1)


def unstack3(a: torch.Tensor) -> V3:
    return (a[..., 0], a[..., 1], a[..., 2])


def add3(a: V3, b: V3) -> V3:
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def sub3(a: V3, b: V3) -> V3:
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def mul3(a: V3, b: V3) -> V3:
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def scale3(a: V3, s) -> V3:
    return (a[0] * s, a[1] * s, a[2] * s)


def neg3(a: V3) -> V3:
    return (-a[0], -a[1], -a[2])


def dot3(a: V3, b: V3) -> torch.Tensor:
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross3(a: V3, b: V3) -> V3:
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The shading's square root. Its own function so that a test can put a
    correctly rounded one in its place: CUDA's sqrtf, which the kernels
    and torch on the card use, is correctly rounded, and torch's float32
    sqrt on the CPU is an ulp off for ~1% of inputs."""
    return torch.sqrt(x)


FLT_MIN = 1.1754943508222875e-38  # the least normal float32


def sign(x: torch.Tensor) -> torch.Tensor:
    """jnp.sign as flexlight_tpu computes it: +-1, the signed zero of x
    for +-0, and NaN for NaN. XLA on the CPU flushes denormal inputs, so
    for |x| < FLT_MIN it is the signed zero too. torch.sign gives +0 for
    -0 and NaN, and +-1 for a denormal."""
    return torch.where(torch.abs(x) < FLT_MIN, x * 0.0,
                       torch.where(torch.isnan(x), x, torch.sign(x)))


def clamp_min0(x: torch.Tensor) -> torch.Tensor:
    """jnp.maximum(x, 0.0): NaN stays NaN and -0 becomes +0 (where
    torch.clamp_min keeps -0)."""
    return torch.clamp_min(x, 0.0) + 0.0


def norm3(a: V3) -> torch.Tensor:
    return sqrt(dot3(a, a))


def normalize3(a: V3) -> V3:
    inv = 1.0 / torch.clamp_min(norm3(a), 1e-30)
    return scale3(a, inv)


def where3(m, a: V3, b: V3) -> V3:
    return (torch.where(m, a[0], b[0]), torch.where(m, a[1], b[1]),
            torch.where(m, a[2], b[2]))


def mix3(a: V3, b: V3, t) -> V3:
    return (a[0] + (b[0] - a[0]) * t, a[1] + (b[1] - a[1]) * t,
            a[2] + (b[2] - a[2]) * t)


def matvec3(m, v: V3) -> V3:
    """m: 9 [N] (or scalar) entries row-major; returns m @ v."""
    return (m[0] * v[0] + m[1] * v[1] + m[2] * v[2],
            m[3] * v[0] + m[4] * v[1] + m[5] * v[2],
            m[6] * v[0] + m[7] * v[1] + m[8] * v[2])
