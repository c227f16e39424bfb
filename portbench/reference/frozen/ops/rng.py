"""Stochastic noise of the path tracer, both modes of Config.rng
(flexlight_tpu/ops/rng.py):

- "hash": the GLSL `noise()` (pathtracer_fragment.glsl:119-121),
  fract(sin(dot(n, (12.9898, 78.233)) + (53,59,61,67)*(seed+rs*PHI))
  * 43758.5453) * 2 - 1, in float32. The sin amplifies a 1-ulp difference
  of its argument or of the libm, so two implementations agree only
  statistically.
- "counter": the float32 bits of the four inputs chained through murmur3
  fmix32 rounds, one keyed round per output channel. Integer ops only, so
  it is bit-exact across packages and devices.
"""

from __future__ import annotations

import numpy as np
import torch

PHI = 1.61803398874989484820459

# murmur3 finalizer constants as two's-complement int32 values
_M1 = int(np.uint32(0x85EBCA6B).astype(np.int32))
_M2 = int(np.uint32(0xC2B2AE35).astype(np.int32))
_C4 = tuple(int(np.uint32(c).astype(np.int32))
            for c in (0x9E3779B9, 0x7F4A7C15, 0x94D049BB, 0xBF58476D))


def fract(x):
    return x - torch.floor(x)


def _sin(x: torch.Tensor) -> torch.Tensor:
    """The hash's sin. Its own function so that a test can put another
    implementation's sin in its place and compare the rest of the
    arithmetic without the libms' 1-ulp differences."""
    return torch.sin(x)


def f32(x, like: torch.Tensor) -> torch.Tensor:
    """`x` (a number or a 0-d tensor) as a float32 scalar on `like`'s device."""
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def noise4(n0: torch.Tensor, n1: torch.Tensor, seed, random_seed,
           mode: str = "hash"):
    """Two [N] coordinate channels -> four [N] channels in [-1, 1)."""
    if mode == "counter":
        return noise4_counter(n0, n1, seed, random_seed)
    d = n0 * 12.9898 + n1 * 78.233
    t = f32(seed, n0) + f32(random_seed, n0) * PHI
    return tuple(fract(_sin(d + o * t) * 43758.5453) * 2.0 - 1.0
                 for o in (53.0, 59.0, 61.0, 67.0))


def _srl(h: torch.Tensor, k: int) -> torch.Tensor:
    """Logical shift right of int32 values."""
    return (h >> k) & ((1 << (32 - k)) - 1)


def _mix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 on int32 (wrapping multiplies, logical shifts)."""
    h = h ^ _srl(h, 16)
    h = h * _M1
    h = h ^ _srl(h, 13)
    h = h * _M2
    h = h ^ _srl(h, 16)
    return h


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).contiguous().view(torch.int32)


def noise4_counter(n0: torch.Tensor, n1: torch.Tensor, seed, random_seed):
    h = _mix32(_bits(n0))
    h = _mix32(h ^ _bits(n1))
    h = _mix32(h ^ _bits(f32(seed, n0).expand(n0.shape)))
    h = _mix32(h ^ _bits(f32(random_seed, n0).expand(n0.shape)))
    out = []
    for c in _C4:
        g = _mix32(h ^ c)
        u = _srl(g, 8)                                  # [0, 2^24)
        out.append(u.to(torch.float32) * (2.0 ** -23) - 1.0)
    return tuple(out)
