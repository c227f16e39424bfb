"""FXAA: the plain version of the FXAA kernel (csrc/fxaa.cu).

The inline FXAA shader of the reference (modules/fxaa.js:7-137), as in
flexlight_tpu/post/fxaa.py: luma edge detection, 6-step edge search with
per-pixel early exit, sub-pixel blend. The data-dependent search runs as
masked steps over shifted images: sample k of a direction is taken while
no earlier sample of it ended the search, and the positive direction gets
what the negative one left of the 6-step budget (fxaa.js:117-134). The
sums run in the order the reference takes its samples.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

EDGE_THRESHOLD_MIN = 1.0 / 32.0
EDGE_THRESHOLD = 1.0 / 2.0
SUBPIX_TRIM = 0.0
SUBPIX_TRIM_SCALE = 1.0
SUBPIX_CAP = 7.0 / 8.0
SEARCH_STEPS = 6


def _shift(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Zero-padded whole-image shift: out[y, x] = img[y+dy, x+dx]."""
    h, w = img.shape[0], img.shape[1]
    out = torch.zeros_like(img)
    out[max(-dy, 0):h + min(-dy, 0), max(-dx, 0):w + min(-dx, 0)] = \
        img[max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0)]
    return out


def _luma(rgba: torch.Tensor) -> torch.Tensor:
    """(g * 0.587/0.299 + r) * a (fxaa.js:26-28)."""
    return (rgba[..., 1] * (0.587 / 0.299) + rgba[..., 0]) * rgba[..., 3]


def fxaa(img: torch.Tensor) -> torch.Tensor:
    """img [H, W, 4] -> antialiased [H, W, 4]. The image is zero-padded by
    SEARCH_STEPS + 2 first, so samples just outside the frame see blur and
    luma computed from zero texels (texelFetch outside the image)."""
    p = SEARCH_STEPS + 2
    padded = F.pad(img.movedim(-1, 0), (p, p, p, p)).movedim(0, -1)
    return _fxaa_core(padded)[p:-p, p:-p]


def _fxaa_core(img: torch.Tensor) -> torch.Tensor:
    luma = _luma(img)
    blur = 0.0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            blur = blur + _shift(img, dy, dx)
    # a tensor divisor: torch on CUDA turns division by a Python number
    # into a multiply by its reciprocal, which rounds differently
    blur = blur / img.new_tensor(9.0)
    blur_luma = _luma(blur)
    lm = {(dy, dx): _shift(luma, dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)}

    # contrast range (fxaa.js:36-41) and sub-pixel blend (fxaa.js:58-68)
    cross_min = torch.minimum(torch.minimum(lm[(-1, 0)], lm[(0, -1)]),
                              torch.minimum(lm[(1, 0)], lm[(0, 1)]))
    cross_max = torch.maximum(torch.maximum(lm[(-1, 0)], lm[(0, -1)]),
                              torch.maximum(lm[(1, 0)], lm[(0, 1)]))
    range_min = torch.minimum(luma, cross_min)
    range_max = torch.maximum(luma, cross_max)
    rng = range_max - range_min
    low_contrast = rng < torch.clamp_min(range_max * EDGE_THRESHOLD, EDGE_THRESHOLD_MIN)
    luma_l = 0.25 * (lm[(-1, 0)] + lm[(0, -1)] + lm[(1, 0)] + lm[(0, 1)])
    range_l = torch.abs(luma_l - luma)
    blend_l = torch.clamp_max(torch.clamp_min(
        range_l / torch.clamp_min(rng, 1e-10) - SUBPIX_TRIM, 0.0) * SUBPIX_TRIM_SCALE,
        SUBPIX_CAP)

    # edge direction (fxaa.js:82-95): lm[(dy, dx)] = luma at (x+dx, y+dy)
    edge_vert = (
        torch.abs(0.25 * lm[(-1, -1)] - 0.5 * lm[(-1, 0)] + 0.25 * lm[(-1, 1)])
        + torch.abs(0.50 * lm[(0, -1)] - 1.0 * lm[(0, 0)] + 0.50 * lm[(0, 1)])
        + torch.abs(0.25 * lm[(1, -1)] - 0.5 * lm[(1, 0)] + 0.25 * lm[(1, 1)]))
    edge_horz = (
        torch.abs(0.25 * lm[(-1, -1)] - 0.5 * lm[(0, -1)] + 0.25 * lm[(1, -1)])
        + torch.abs(0.50 * lm[(-1, 0)] - 1.0 * lm[(0, 0)] + 0.50 * lm[(1, 0)])
        + torch.abs(0.25 * lm[(-1, 1)] - 0.5 * lm[(0, 1)] + 0.25 * lm[(1, 1)]))
    horz_span = edge_horz >= edge_vert  # edge runs along x: search along x

    # highest-contrast neighbour luma + gradient (fxaa.js:109-115)
    luma_mcn = torch.maximum(
        torch.maximum(torch.abs(lm[(-1, 0)] - luma), torch.abs(lm[(0, 1)] - luma)),
        torch.maximum(torch.abs(lm[(1, 0)] - luma), torch.abs(lm[(0, -1)] - luma)))
    gradient = torch.abs(luma_mcn - luma)

    def sample(image, sign, k):
        """image at |offset| k + 1 along the span direction."""
        o = sign * (k + 1)
        sel = horz_span if image.ndim == 2 else horz_span[..., None]
        return torch.where(sel, _shift(image, 0, o), _shift(image, o, 0))

    color = img
    count = torch.ones_like(luma)
    steps_n = torch.zeros_like(luma)
    active = torch.ones_like(luma, dtype=torch.bool)
    for k in range(SEARCH_STEPS):      # negative direction (fxaa.js:119-124)
        fv, lb, bl = sample(img, -1, k), sample(blur, -1, k), sample(blend_l, -1, k)
        color = torch.where(active[..., None], color + (fv + (lb - fv) * bl[..., None]), color)
        count = count + active.to(torch.float32)
        steps_n = steps_n + active.to(torch.float32)
        active = active & ~(torch.abs(sample(blur_luma, -1, k) - luma_mcn) >= gradient)
    # positive direction with the rest of the 6-step budget (fxaa.js:125-130)
    active = torch.ones_like(luma, dtype=torch.bool)
    for k in range(SEARCH_STEPS):
        take = active & (k < SEARCH_STEPS - steps_n)
        fv, lb, bl = sample(img, 1, k), sample(blur, 1, k), sample(blend_l, 1, k)
        color = torch.where(take[..., None], color + (fv + (lb - fv) * bl[..., None]), color)
        count = count + take.to(torch.float32)
        active = active & ~(torch.abs(sample(blur_luma, 1, k) - luma_mcn) >= gradient)
    return torch.where(low_contrast[..., None], img, color / count[..., None])
