"""Shared post-processing helpers (flexlight_tpu/post/common.py).

The reference stores every intermediate pass in RGBA8 textures and its
gates compare those quantized values for exact equality;
`quantize_rgba8` reproduces the store, `gather` texelFetch's zero result
outside the image.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

INV_255 = 1.0 / 255.0
INV_256 = 1.0 / 256.0


def quantize_rgba8(v: torch.Tensor) -> torch.Tensor:
    """Clamp to [0, 1] and snap to 8-bit levels (RGBA8 texture store)."""
    return torch.round(torch.clamp(v, 0.0, 1.0) * 255.0) * INV_255


def split_hdr(color: torch.Tensor):
    """fract/floor HDR split for RGBA8 storage (glsl:621-623)."""
    frac = color - torch.floor(color)
    high = torch.floor(color) * INV_256
    return quantize_rgba8(frac), quantize_rgba8(high)


def gather(img: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    """texelFetch at (pixel + (dy, dx)) with zero outside the image.
    img [H, W, C], dy/dx [H, W] int offsets -> [H, W, C]."""
    h, w = img.shape[0], img.shape[1]
    yy = torch.arange(h, device=img.device)[:, None] + dy
    xx = torch.arange(w, device=img.device)[None, :] + dx
    inb = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
    flat = (torch.clamp(yy, 0, h - 1) * w + torch.clamp(xx, 0, w - 1)).reshape(-1)
    vals = img.reshape(h * w, -1)[flat].reshape(img.shape)
    return torch.where(inb[..., None], vals, torch.zeros_like(vals))


def shifted(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[y, x] = img[y+dy, x+dx] with zero outside the image; img is
    [H, W] or [H, W, C]."""
    h, w = img.shape[0], img.shape[1]
    py = (max(-dy, 0), max(dy, 0))
    px = (max(-dx, 0), max(dx, 0))
    x = img if img.ndim == 3 else img[..., None]
    p = F.pad(x.movedim(-1, 0), (px[0], px[1], py[0], py[1])).movedim(0, -1)
    out = p[py[0] + dy:py[0] + dy + h, px[0] + dx:px[0] + dx + w]
    return out if img.ndim == 3 else out[..., 0]


def reinhard_gamma(color: torch.Tensor) -> torch.Tensor:
    """Reinhard tone map + the reference's gamma curve
    (pathtracer_final_filter.glsl:61-67)."""
    c = color / (color + 1.0)
    return torch.pow(torch.clamp_min(4.0 * c, 0.0), 1.0 / 0.8) / 4.0 * 1.3
