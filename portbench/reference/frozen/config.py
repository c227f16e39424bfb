"""Render configuration.

The port's own copy of flexlight_tpu/config.py (flexlight_tpu_torch imports
nothing of the JAX package).

Counterpart of `modules/config.js:1-16`: same knob names and
defaults. The config is a frozen, hashable dataclass.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Config:
    samples_per_ray: int = 1
    render_quality: float = 1.0
    max_reflections: int = 5
    min_importancy: float = 0.3
    first_passes: int = 3
    second_passes: int = 3
    temporal: bool = True
    temporal_samples: int = 4
    filter: bool = False
    # Denoise-chain flavor (not a reference knob): "fast" tile-quantizes the per-pixel blur radius key
    # (post.common.tileize_blur_key) so the filter kernels' offset
    # skipping and active-tile compaction engage; "compat" replicates the
    # reference's per-pixel key arithmetic-exactly (the parity-proof
    # mode). Edge-stopping gates are identical in both modes.
    filter_mode: str = "fast"
    hdr: bool = True
    antialiasing: str | None = "fxaa"
    # RNG flavor (not a reference knob): "hash" = GLSL noise() compat
    # (golden/oracle parity), "counter" = murmur3-quality counter hash
    # (SURVEY §7 RNG plan). Changing it changes the sample sequence.
    rng: str = "hash"

    # camelCase read aliases for 1:1 example ports
    @property
    def samplesPerRay(self):
        return self.samples_per_ray

    @property
    def maxReflections(self):
        return self.max_reflections

    @property
    def minImportancy(self):
        return self.min_importancy

    @property
    def temporalSamples(self):
        return self.temporal_samples

    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)
