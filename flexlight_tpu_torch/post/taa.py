"""TAA (flexlight_tpu/post/taa.py on torch; modules/taa.js): a 9-frame
history average whose older frames are clamped to the 3x3 neighbourhood
min / max of the current frame, and the zero-sum camera jitter sequence.
The reference's GL texture ring (taa.js:109-127) is a [9, H, W, 4]
history tensor, newest frame at index 0."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

FRAMES = 9  # taa.js:6


class TAAState(NamedTuple):
    history: torch.Tensor  # [FRAMES, H, W, 4] f32, newest at index 0

    @staticmethod
    def create(height: int, width: int, device) -> "TAAState":
        return TAAState(history=torch.zeros((FRAMES, height, width, 4), dtype=torch.float32,
                                            device=device))


def taa_history(antialiasing: str, height: int, width: int, device) -> TAAState | None:
    """The history a renderer keeps: a TAAState (299 MB at 1080p) under
    antialiasing="taa", else None."""
    return TAAState.create(height, width, device) if antialiasing == "taa" else None


def neighborhood_clamp(cur: torch.Tensor):
    """3x3 min / max of the current frame [H, W, C], zero outside the image
    (texelFetch out of bounds, taa.js:45-52); the min capped at 1 and the
    max floored at 0. Returns (min_rgb, max_rgb)."""
    h, w = cur.shape[0], cur.shape[1]
    pad = F.pad(cur.movedim(-1, 0), (1, 1, 1, 1)).movedim(0, -1)
    stac = torch.stack([pad[1 + dy:h + 1 + dy, 1 + dx:w + 1 + dx]
                        for dy in (-1, 0, 1) for dx in (-1, 0, 1)], dim=0)
    return (torch.clamp_max(stac.amin(dim=0), 1.0),
            torch.clamp_min(stac.amax(dim=0), 0.0))


def taa_apply(state: TAAState, frame: torch.Tensor, clamp=None):
    """Push `frame` [H, W, 4] and average it with the older frames clamped
    to its neighbourhood (taa.js:25-58), summed one after another from the
    newest as the reference sums them. `clamp` optionally supplies the
    precomputed (min_rgb, max_rgb) of `neighborhood_clamp` (the sharded
    pipeline takes them over a halo-exchanged strip). Returns (out
    [H, W, 4], state)."""
    history = torch.cat([frame[None], state.history[:-1]], dim=0)
    cur = history[0]
    min_rgb, max_rgb = neighborhood_clamp(cur) if clamp is None else clamp
    out = cur
    for i in range(1, FRAMES):
        out = out + torch.minimum(torch.maximum(history[i], min_rgb), max_rgb)
    return out / FRAMES, TAAState(history=history)


def gen_zero_sum_jitter(n: int = FRAMES, seed: int = 0) -> np.ndarray:
    """n pseudo-random 2D vectors summing to zero (taa.js:139-155), drawn
    from numpy's default_rng(seed) as flexlight_tpu draws them."""
    rng = np.random.default_rng(seed)
    vecs = np.zeros((n, 2))
    vecs[0] = [0, 1]
    vecs[1] = [1, 0]
    combined = np.array([1.0, 1.0])
    for i in range(2, n):
        for j in range(2):
            lo = max(-min(i + 1, n - 1 - i), combined[j] - 1)
            hi = min(min(i + 1, n - 1 - i), combined[j] + 1)
            r = np.sign(rng.random() - 0.5) * np.sqrt(rng.random() * 0.5)
            vecs[i][j] = 0.5 * ((hi + lo) + (hi - lo) * r) - combined[j]
            combined[j] += vecs[i][j]
    return vecs


class Jitter:
    """Per-frame camera jitter cycling through the zero-sum set
    (taa.js:129-136)."""

    def __init__(self, seed: int = 0):
        self.vecs = gen_zero_sum_jitter(seed=seed)
        self.current = 0

    def next(self, width: int, height: int) -> tuple[float, float]:
        self.current = (self.current + 1) % FRAMES
        scale = 0.3 / min(width, height)
        return (self.vecs[self.current][0] * scale, self.vecs[self.current][1] * scale)
