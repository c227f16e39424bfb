"""The simple renderer (flexlight_tpu/models/simple.py on torch): the
reference's WebGPU backend (modules/pathtracerWGPU.js,
shaders/pathtracer.wgsl:221-238), shadowed diffuse against lights[0] with
the flat first-vertex normal and the inline albedo, 0.1x albedo in
shadow, no bounces and no post. Both casts are ops.traverse's scan, plain
PyTorch as flexlight_tpu's is plain XLA: no kernel runs here."""

from __future__ import annotations

import torch

from ..ops import traverse as trv
from ..ops import vec3 as v3
from ..ops.geometry import world_geometry
from ..ops.intersect import BIAS
from ..ops.pathtrace import camera_rays, inverse_view
from ..utils.debug import assert_finite
from .base import Renderer


def simple_frame(buffers, cam_pos, view, width: int, height: int) -> torch.Tensor:
    """One frame [H, W, 3] on the buffers' device; `cam_pos` and `view`
    come from the camera (host arrays)."""
    dev = buffers.geometry.device
    world_geom = world_geometry(buffers)
    o3, d3, _ = camera_rays(width, height, torch.as_tensor(cam_pos, dtype=torch.float32,
                                                           device=dev), inverse_view(view))
    origin, direction = torch.stack(o3, dim=-1), torch.stack(d3, dim=-1)
    # the reference's WebGPU backend rasterizes its primaries (watertight):
    # the relaxed edge window closes the ray-cast seam
    hit = trv.traverse_scan(world_geom, origin, direction, edge=-BIAS)
    covered = hit.triangle != -1
    tri = torch.clamp_min(hit.triangle, 0).long()

    world_pos = origin + hit.suv[:, 0:1] * direction
    attr = buffers.attributes[tri]
    normal = attr[:, 0:3]            # flat first-vertex normal (wgsl:228)
    albedo = attr[:, 18:21]

    d = buffers.lights[0, 0][None, :] - world_pos
    dist = v3.norm3(v3.unstack3(d))
    unit = d / torch.clamp_min(dist, 1e-30)[:, None]
    shadowed = trv.shadow_scan(world_geom, world_pos, unit, dist)
    n_dot_l = v3.dot3(v3.unstack3(normal), v3.unstack3(unit))
    color = torch.where(shadowed[:, None], 0.1 * albedo, albedo * n_dot_l[:, None])
    rgb = torch.where(covered[:, None], torch.clamp(color, 0.0, 1.0), 0.0)
    return rgb.reshape(height, width, 3)


class SimplePathTracer(Renderer):
    type = "pathtracer"

    def render(self):
        self._halt = False
        if self._buffers is None:
            self.update_scene()

    def _render_device(self) -> torch.Tensor:
        if self._buffers is None:
            self.update_scene()
        # fpsLimit throttling (pathtracerWGPU.js frameCycle cadence)
        self._throttle()
        view = self.camera.view_matrix(self.width, self.height)
        out = simple_frame(self._buffers, self.camera.position, view, self.width, self.height)
        assert_finite(out, "simple.frame")
        self._frame_count += 1
        return out

    def _frame_extra(self) -> dict:
        return {"scheme": "scan"}
