"""The rasterizer's delivered frame, worked out again in plain PyTorch:
the reference of a configuration whose `reference` is "rasterizer".

The rasterizer keeps no history under FXAA: a delivered frame is its own
frame alone, rendered from its pose by the frozen copy of the frame
(`reference/frozen/models/rasterizer.py`) with the casts' and FXAA's plain
versions. The scene, the pose, the noise-free camera and the cast
counting are the path tracer's reference's (`Reference` below extends
it); TAA has no reference yet.

`precision="bfloat16"` is the control: the scene buffers and the camera
rounded to bfloat16 as the path tracer's control rounds them, and each
layer's shaded rgb and alpha too, the step below the float32 the
configuration states. `counting()` records the live rays of every
closest-hit and any-hit cast, which `raster_cast_roofline` reads.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.frozen.models import rasterizer as raster
from portbench.reference.renderers import pathtracer


class Reference(pathtracer.Reference):
    """The rasterizer's frames of a configuration's scene on `device`
    (`engine`, `at`: as the path tracer's reference takes them)."""

    def __init__(self, cfg: dict, engine, at, device):
        super().__init__(cfg, engine, at, device)
        self.scheme = raster.resolved_scheme(cfg["scheme"], self.buffers.id_buffer.shape[0])
        self.layers = raster.resolved_layers(self.buffers)

    def frames_of(self, frame: int) -> list[int]:
        return [frame]

    def display_u8(self, poses, frames, precision: str = "float32") -> np.ndarray:
        """The [H, W, 3] uint8 frame the program delivers for frame
        `frames[-1]` from `poses[-1]`."""
        buffers, position, view = self._at(poses[-1], frames[-1], precision)
        display = raster.raster_frame(
            buffers, position, view, self.width, self.height, self.config, pathtracer.PLAIN,
            scheme=self.scheme, layers=self.layers,
            layer_out=pathtracer._bf16 if precision == "bfloat16" else None)
        return torch.round(torch.clamp(display, 0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy()
