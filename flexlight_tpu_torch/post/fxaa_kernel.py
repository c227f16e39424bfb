"""FXAA as kernel 3 of the port (csrc/fxaa.cu): `fxaa_cuda` takes
[H, W, 4] float32 and returns [H, W, 4] float32; on CPU tensors it runs
the plain version, post/fxaa.py."""

from __future__ import annotations

import torch

from .. import _native
from .fxaa import fxaa


def _fxaa_launch(lib, stream, img: torch.Tensor) -> torch.Tensor:
    if img.ndim != 3 or img.shape[2] != 4:
        raise ValueError(f"img: expected [H, W, 4], got {tuple(img.shape)}")
    h, w = img.shape[0], img.shape[1]
    _native.require(img, "img", torch.float32, (h, w, 4), img.device)
    if img.data_ptr() % 16:
        raise ValueError("img: the kernel loads a texel as 16 bytes and needs them aligned")
    out = torch.empty_like(img)
    _native.check(lib.fl_fxaa(_native.ptr(img), h, w, _native.ptr(out), stream),
                  "fxaa")
    return out


fxaa_cuda = _native.Kernel("fxaa", fxaa, _fxaa_launch)
