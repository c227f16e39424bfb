"""The rasterizer (flexlight_tpu/models/rasterizer.py on torch), the
engine's default renderer: the reference's modules/rasterizerWGL2.js and
shaders/rasterizer_fragment.glsl as direct lighting of the primary
visibility, found by ray casts instead of instanced rasterization;
Cook-Torrance per light with a shadow ray each, translucency fade,
Reinhard + gamma, and FXAA or TAA.

The casts come from the scheme: "kernel" the dense closest-hit / any-hit
kernels (ops.intersect_kernel, through a kernels.KernelSet), "sparse" the
worklist casts of ops.intersect_sparse (unsorted: the rasterizer's casts
carry no hint, so the flags, closest- and any-hit kernels run and the
sort key never does), "scan" and "packet" the plain casts of
ops.traverse, "mxu" and "clustered" those of ops.traverse_mxu and
ops.traverse_clustered (the primaries with the relaxed edge -BIAS, as
flexlight_tpu/models/rasterizer.py:147-153, 193-199 wires them). "auto"
takes flexlight_tpu's rule on a chip on every device
(ops.pathtrace.resolve_scheme): "sparse" from 4096 triangles, else
"kernel". Every scheme shades a hit layer in the kernel set's three
shading kernels (ops.raster_kernel, csrc/raster.cu; their plain versions
on the CPU), around its own shadow casts; the AA tail is the post
chain's (post.chain.antialias).

Reference quirks kept: forwardTrace gets the light vector from the local
(untransformed) position and the view vector camera - localPosition
(rasterizer_fragment.glsl:269), while the shadow ray leaves from the world
position (glsl:267-268); every light casts its shadow ray, active or not,
for every pixel, a miss's from triangle 0's point."""

from __future__ import annotations

import torch

from .. import _native
from ..kernels import KERNELS, KernelSet
from ..ops import vec3 as v3
from ..ops.geometry import world_geometry
from ..ops.intersect import BIAS
from ..ops.pathtrace import camera_rays, inverse_view, resolve_scheme, scheme_casts
from ..post.chain import antialias
from ..post.common import quantize_rgba8
from ..post.taa import Jitter, TAAState, taa_history
from ..utils.debug import assert_finite
from ..utils.timing import span
from .base import Renderer


def _shade(buffers, cam_pos, hit, shadow_fn, config, kernels: KernelSet):
    """Shade one primary-visibility layer (rasterizer_fragment.glsl main):
    per-light Cook-Torrance and shadow rays, translucency fade, Reinhard,
    in the kernel set's three roles (ops.raster_kernel) around the
    scheme's shadow casts: raster_surface (the rays' origin), then a
    light at a time raster_rays and its shadow cast, then raster_shade.
    `hit` is (s, u, v, slot) of [N]. Returns (rgb [N, 3] clamped, alpha
    [N]), the fragment shader's vec4(finalColor, 1 - 0.5 * tpo.x)
    (glsl:291)."""
    _, hu, hv, slot = hit
    hu, hv, slot = hu.contiguous(), hv.contiguous(), slot.contiguous()
    origin = kernels.raster_surface(buffers.geometry, buffers.rotations, buffers.shifts, hu, hv,
                                    slot)
    flags = []
    for j in range(buffers.lights.shape[0]):
        rays = kernels.raster_rays(origin, buffers.lights, j)
        flags.append(shadow_fn(origin.T, rays[:3].T, rays[3]))
    shadowed = torch.stack(flags) if flags else hu.new_zeros((0, hu.shape[0]), dtype=torch.bool)
    return kernels.raster_shade(buffers.geometry, buffers.attributes, buffers.rotations,
                                buffers.albedo_tab, buffers.pbr_tab, buffers.tpo_tab,
                                buffers.lights, buffers.ambient, cam_pos, hu, hv, slot, shadowed,
                                config.hdr)


# static compare-swap networks sorting k layers by draw order
_SORT_PAIRS = {1: [], 2: [(0, 1)], 3: [(0, 1), (1, 2), (0, 1)],
               4: [(0, 1), (2, 3), (0, 2), (1, 3), (1, 2)]}


def _blend_layers(layers_data):
    """Replay the reference's GL raster state over K depth-ordered hit
    layers a pixel: depth test LESS with depth writes and blending both on
    (rasterizerWGL2.js:394-399, blendFuncSeparate(ONE, ONE_MINUS_SRC_ALPHA,
    ONE, ONE)). GL takes fragments in draw order (the geometry slot order):
    a fragment passes iff strictly closer than every earlier one, then
    blends dst = src.rgb + dst.rgb * (1 - src.a), dst.a = src.a + dst.a,
    each write clamped by the RGBA8 canvas. `layers_data` holds (dist,
    slot, rgb, alpha, covered) per layer; returns (rgb [N, 3], alpha [N])."""
    layers = list(layers_data)
    k = len(layers)
    key = [torch.where(layer[4], layer[1], 2 ** 30) for layer in layers]

    def pick(cond, a, b):
        return torch.where(cond[:, None] if b.ndim == 2 else cond, a, b)

    for i, j in _SORT_PAIRS.get(k, [(a, b) for a in range(k) for b in range(a + 1, k)]):
        take = key[j] < key[i]
        key[i], key[j] = torch.where(take, key[j], key[i]), torch.where(take, key[i], key[j])
        layers[i], layers[j] = (tuple(pick(take, b, a) for a, b in zip(layers[i], layers[j])),
                                tuple(pick(take, a, b) for a, b in zip(layers[i], layers[j])))

    n = layers[0][0].shape[0]
    dev = layers[0][0].device
    z = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    rgb = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    a_dst = torch.zeros((n,), dtype=torch.float32, device=dev)
    for dist, _slot, src_rgb, src_a, covered in layers:
        passes = covered & (dist < z)
        blended = torch.clamp(src_rgb + rgb * (1.0 - src_a[:, None]), 0.0, 1.0)
        rgb = torch.where(passes[:, None], blended, rgb)
        a_dst = torch.where(passes, torch.clamp(src_a + a_dst, 0.0, 1.0), a_dst)
        z = torch.where(passes, dist, z)
    return rgb, a_dst


def _casts(scheme: str, buffers, world_geom, kernels: KernelSet, tile: int):
    """(traverse_fn(o, d) -> (s, u, v, slot), shadow_fn(o, d, max_len) ->
    bool), rays as [N, 3] rows, over the path tracer's casts of `scheme`
    (ops.pathtrace.scheme_casts; unhinted, so the worklist casts stay unsorted).
    Every closest-hit cast stands in for the raster draw (watertight
    coverage), so it takes the relaxed edge window -BIAS; the worklist
    casts' drawable indices are mapped to the slots the shading reads."""
    traverse_soa, shadow_soa = scheme_casts(scheme, buffers, world_geom, kernels, tile)

    def traverse_fn(o, d):
        s, u, v, tri = traverse_soa(v3.unstack3(o), v3.unstack3(d), edge=-BIAS)
        if scheme == "sparse":
            tri = torch.where(tri >= 0, buffers.id_buffer[torch.clamp_min(tri, 0).long()], -1)
        return s, u, v, tri

    def shadow_fn(o, d, max_len):
        return shadow_soa(v3.unstack3(o), v3.unstack3(d), max_len)

    return traverse_fn, shadow_fn


def raster_frame(buffers, cam_pos, view, taa_state: TAAState | None, width: int, height: int,
                 config, scheme: str = "scan", tile: int = 1024, layers: int = 1,
                 kernels: KernelSet = KERNELS):
    """One frame: (display [H, W, 3] in [0, 1], TAA state). `cam_pos` and
    `view` come from the camera (host arrays); `layers` translucent hit
    layers are extracted a pixel and blended in draw order (1: the closest
    hit alone). Traced: each layer's fl.raster.cast {layer} and
    fl.raster.shade {layer} (its shadow casts included), fl.raster.blend
    and fl.aa."""
    dev = buffers.geometry.device
    cam_pos = torch.as_tensor(cam_pos, dtype=torch.float32, device=dev)
    world_geom = world_geometry(buffers)
    traverse_fn, shadow_fn = _casts(scheme, buffers, world_geom, kernels, tile)
    o3, d3, _ = camera_rays(width, height, cam_pos, inverse_view(view))
    origin, direction = torch.stack(o3, dim=-1), torch.stack(d3, dim=-1)

    # Up to `layers` hit layers front to back by ray continuation (re-cast
    # from each hit point; s > BIAS rejects the surface itself), then the
    # replay of GL's draw-order blending. With everything opaque the replay
    # reduces to the closest hit, so the renderer asks for more layers only
    # when the scene has translucent material.
    layers_data = []
    o = origin
    cum = torch.zeros(origin.shape[0], dtype=torch.float32, device=dev)
    for layer in range(layers):
        with span("fl.raster.cast", layer=layer):
            hit = traverse_fn(o, direction)
        with span("fl.raster.shade", layer=layer):
            rgb_l, a_l = _shade(buffers, cam_pos, hit, shadow_fn, config, kernels)
        dist_l = cum + hit[0]
        layers_data.append((dist_l, hit[3], rgb_l, a_l, hit[3] != -1))
        if layer + 1 < layers:
            o = o + direction * hit[0][:, None]
            cum = dist_l

    if layers == 1:
        _, _, rgb_l, a_l, covered = layers_data[0]
        rgb = torch.where(covered[:, None], rgb_l, 0.0)
        a = torch.where(covered, a_l, 0.0)
    else:
        with span("fl.raster.blend"):
            rgb, a = _blend_layers(layers_data)
    display = rgb.reshape(height, width, 3)
    alpha_img = a.reshape(height, width)

    if config.antialiasing in ("fxaa", "taa"):
        display, taa_state = antialias(display, alpha_img, quantize_rgba8, taa_state, config,
                                       kernels.fxaa)
    return torch.clamp(display, 0.0, 1.0), taa_state


class Rasterizer(Renderer):
    """The rasterizer with the reference's surface, on one explicit torch
    device. `layers` (default 4) is the most translucent layers blended a
    pixel; a scene without translucent material renders 1. Traced, a
    frame's raster_frame is the span fl.raster {scheme, layers, shade}:
    `shade` is "kernel" where the layers are shaded in csrc/raster.cu's
    kernels (CUDA tensors through the kernel wrappers), else "plain"."""

    type = "rasterizer"

    def __init__(self, width, height, scene, camera, config, device, scheme: str = "auto",
                 tile: int = 1024, kernels: KernelSet = KERNELS):
        super().__init__(width, height, scene, camera, config, device)
        self.scheme = scheme
        self.tile = tile
        self.kernels = kernels
        self.layers = 4
        self._has_translucency = False
        self._taa_state = None
        self._jitter = Jitter()
        self._prepared_shape = None

    def update_scene(self):
        super().update_scene()
        # attributes[:, 24]: per-triangle translucency; a TPO atlas larger
        # than its 1x1 default allows texture-driven translucency
        self._has_translucency = bool((self._buffers.attributes[:, 24] > 0.0).any()) or \
            self._buffers.tpo_atlas.numel() > 3

    def resolved_scheme(self) -> str:
        """The scheme a frame runs: ops.pathtrace.resolve_scheme without
        the fused schemes ("auto": "sparse" or "kernel")."""
        if self.scheme == "auto" and self._buffers is None:
            self.update_scene()
        return resolve_scheme(self.scheme, self._buffers)

    def resolved_layers(self) -> int:
        if self._buffers is None:
            self.update_scene()
        return max(int(self.layers), 1) if self._has_translucency else 1

    def render(self):
        self._halt = False
        self._prepare()

    def _prepare(self):
        if self._buffers is None:
            self.update_scene()
        shape = (self.height, self.width, self.config)
        if self._prepared_shape != shape:
            self._taa_state = taa_history(self.config.antialiasing, self.height,
                                          self.width, self.device)
            self._prepared_shape = shape

    def _render_device(self) -> torch.Tensor:
        if self._halt:
            self.render()
        # fpsLimit throttling (rasterizerWGL2.js:248-250)
        self._throttle()
        self._prepare()
        self._refresh_transforms()
        jitter = (0.0, 0.0)
        if self.config.antialiasing == "taa":
            jitter = self._jitter.next(self.width, self.height)
        view = self.camera.view_matrix(self.width, self.height, jitter)
        scheme, layers = self.resolved_scheme(), self.resolved_layers()
        shade = "kernel" if self.device.type == "cuda" and isinstance(
            self.kernels.raster_shade, _native.Kernel) else "plain"
        with span("fl.raster", scheme=scheme, layers=layers, shade=shade):
            display, self._taa_state = raster_frame(
                self._buffers, self.camera.position, view, self._taa_state, self.width,
                self.height, self.config, scheme=scheme, tile=self.tile, layers=layers,
                kernels=self.kernels)
        assert_finite((display, self._taa_state), "rasterizer.frame")
        self._frame_count += 1
        return display

    def _frame_extra(self) -> dict:
        return {"scheme": self.resolved_scheme(), "layers": self.resolved_layers()}
