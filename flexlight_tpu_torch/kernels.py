"""The hand-written kernels a frame launches, by role, for every renderer.

`KERNELS` (the default of the path tracer, the rasterizer, the post chain
and the multi-device frames) holds the kernel wrappers of ops/ and post/;
`PLAIN` their plain PyTorch versions, which run the same frame without
any kernel of this package. A caller may pass any `KernelSet`, such as
`PLAIN._replace(fxaa=...)`."""

from __future__ import annotations

from typing import Callable, NamedTuple

from .ops.fused_kernel import fused_frame, sp_post, sp_pre
from .ops.intersect_kernel import any_hit, closest_hit
from .ops.intersect_sparse_kernel import sparse_any, sparse_closest, sparse_flags, sparse_key
from .ops.raster_kernel import raster_rays, raster_shade, raster_surface
from .ops.shade_kernel import interp_shade, shade
from .post.filter_kernel import final_blur, first_blur, second_blur
from .post.fxaa_kernel import fxaa_cuda


class KernelSet(NamedTuple):
    """The kernels of a frame, by role: the casts (dense, fused PRE / POST,
    whole frame, sparse worklist), the shading kernels (path tracer:
    shade, interp_shade; rasterizer: raster_surface, raster_rays,
    raster_shade: ops.raster_kernel), the filter passes and FXAA."""
    closest_hit: Callable
    any_hit: Callable
    first_blur: Callable
    second_blur: Callable
    final_blur: Callable
    fxaa: Callable
    sp_pre: Callable
    sp_post: Callable
    sparse_flags: Callable
    sparse_key: Callable
    sparse_closest: Callable
    sparse_any: Callable
    shade: Callable
    interp_shade: Callable
    fused_frame: Callable
    raster_surface: Callable
    raster_rays: Callable
    raster_shade: Callable


KERNELS = KernelSet(closest_hit, any_hit, first_blur, second_blur, final_blur,
                    fxaa_cuda, sp_pre, sp_post, sparse_flags, sparse_key, sparse_closest,
                    sparse_any, shade, interp_shade, fused_frame, raster_surface, raster_rays,
                    raster_shade)
PLAIN = KernelSet(*(k.plain for k in KERNELS))
