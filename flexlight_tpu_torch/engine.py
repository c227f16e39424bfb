"""Engine facade (flexlight.js:13-142) over the shared Scene / Camera /
Config of flexlight_tpu, building the port's renderers on one explicit
torch device."""

from __future__ import annotations

import torch

from flexlight_tpu.engine import FlexLight as _SharedFlexLight


class FlexLight(_SharedFlexLight):
    """`FlexLight(canvas, device=...)`: the properties and the hot-swap by
    string key of flexlight_tpu.FlexLight; `renderer = "pathtracer"` builds
    flexlight_tpu_torch's PathTracer on `device`. The other renderers are
    not ported yet (ROADMAP.md)."""

    def __init__(self, canvas=None, *, device):
        super().__init__(canvas)
        self.device = torch.device(device)

    def _make_renderer(self, name: str):
        if self._api in ("webgpu", "simple") or name == "rasterizer":
            raise NotImplementedError(
                f"renderer {name!r} on api {self._api!r} is not ported yet (ROADMAP.md)")
        if name != "pathtracer":
            raise ValueError(f"Renderer option {name!r} on api {self._api!r} doesn't exist.")
        from .models.pathtracer import PathTracer

        width, height = self._canvas
        return PathTracer(width, height, self._scene, self._camera, self._config,
                          self.device)
