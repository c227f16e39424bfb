"""Debug-mode NaN / Inf guards (flexlight_tpu/utils/debug.py on torch).

The renderers call `assert_finite` on each frame's display and history
state. It checks only while debug mode is on, which `set_debug(True)`
turns on; it is off by default and no environment variable turns it on.
Each check copies a verdict to the host, so it waits for the frame."""

from __future__ import annotations

import torch

_DEBUG = False


def debug_enabled() -> bool:
    return _DEBUG


def set_debug(enabled: bool) -> None:
    global _DEBUG
    _DEBUG = bool(enabled)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _leaves(x)


def assert_finite(tree, name: str) -> None:
    """Raise FloatingPointError if a floating tensor of `tree` (a tensor or
    nested tuples / lists / NamedTuples of them) holds a NaN or an Inf,
    when debug mode is on; a no-op otherwise."""
    if not _DEBUG:
        return
    for k, leaf in enumerate(x for x in _leaves(tree) if x.is_floating_point()):
        bad = int((~torch.isfinite(leaf)).sum())
        if bad:
            raise FloatingPointError(f"non-finite values in {name}[leaf {k}]: {bad} elements "
                                     f"(shape {tuple(leaf.shape)})")
