"""The one generator of input schedules: a traffic mix's parameters and a
seed give the events a viewer sends, as (ms after the window opens,
kind, arguments).

Keys: one of the mix's `keys` is held at every moment, for a time drawn
from `hold_ms`, then its opposite (`opposite`) for the same time: a key
pair, which walks the camera away and back. Drags: at the start of a
share `drag_share` of the key pairs a mouse move of (dx, dy) pixels
within `drag_px` turns the camera, and at the start of the next pair the
move back (-dx, -dy) turns it back; so each pair walks under one heading
and ends where it began, and the camera stays near the scene's start
pose. Every seed gets the same set of holds, keys and drags, in another
order: each cycle of `pairs_per_cycle` pairs takes evenly spaced holds
and moves, the keys in equal numbers, shuffled by the seed.
"""

from __future__ import annotations

import numpy as np


def _cycle(mix: dict, rng) -> list[tuple]:
    """(key, hold ms, drag or None) of one cycle of key pairs."""
    n = int(mix["pairs_per_cycle"])
    lo, hi = mix["hold_ms"]
    holds = rng.permutation(np.linspace(lo, hi, n))
    keys = [mix["keys"][i % len(mix["keys"])] for i in rng.permutation(n)]
    n_drags = int(round(n * mix["drag_share"]))
    (dx_lo, dx_hi), (dy_lo, dy_hi) = mix["drag_px"]
    drags = [(float(dx), float(dy)) for dx, dy in zip(
        np.linspace(dx_lo, dx_hi, n_drags), rng.permutation(np.linspace(dy_lo, dy_hi, n_drags)))]
    slots = set(int(i) for i in rng.permutation(n)[:n_drags])
    drags_at = iter(rng.permutation(len(drags)))
    return [(k, float(h), drags[next(drags_at)] if i in slots else None)
            for i, (k, h) in enumerate(zip(keys, holds))]


def schedule(mix: dict, seed: int, horizon_ms: float) -> list[tuple]:
    """Events [(t_ms, "keydown" | "keyup", code) or (t_ms, "mouse", dx,
    dy)] up to `horizon_ms`, in the order a viewer sends them."""
    rng = np.random.default_rng(seed)
    events, t, undo = [], 0.0, None
    while t < horizon_ms:
        for key, hold, drag in _cycle(mix, rng):
            if undo is not None:
                events.append((t, "mouse", -undo[0], -undo[1]))
                undo = None
            if drag is not None:
                events.append((t, "mouse", float(drag[0]), float(drag[1])))
                undo = drag
            for code in (key, mix["opposite"][key]):
                events.append((t, "keydown", code))
                t += hold
                events.append((t, "keyup", code))
    if undo is not None:
        events.append((t, "mouse", -undo[0], -undo[1]))
    return events


def sample_points(seed: int, count: int) -> list[float]:
    """`count` points of the window (shares of its length) at which a run
    keeps the frame delivered next for the comparison: count - 1 drawn
    from the seed in (0.2, 0.95), and the window's end (1.0)."""
    rng = np.random.default_rng([seed, 1])
    return sorted(float(x) for x in rng.uniform(0.2, 0.95, max(count - 1, 0))) + [1.0]
