"""Scenes of the port's slice.

`theater` is examples/theater.py's build_scene line for line (the port of
the reference's examples/theater.js: 9 lights, wood-textured floor,
striped metallic back mirror), on the port's engine, taking the floor
texture as an argument: the original loads textures/holz.jpg, which this
repository does not carry. `stand_in_wood_texture` makes a stand-in of the
same size from a seed. Given another engine (`engine=`, such as
flexlight_tpu's FlexLight), `theater` builds the same scene with that
engine's own classes, so a test can flatten both packages' scenes.
"""

from __future__ import annotations

import numpy as np

from .engine import FlexLight
from .scene.scene import Texture


def stand_in_wood_texture(seed: int) -> Texture:
    """`stand_in_wood_data(seed)` as a Texture."""
    return Texture(stand_in_wood_data(seed))


def stand_in_wood_data(seed: int) -> np.ndarray:
    """A 512 x 512 x 3 float32 wood-grain image from `seed`: warped rings
    plus grain noise, stored as k * f32(1/255) like an image texture (so
    its atlas table keeps it as exact bytes)."""
    size = 512
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:size, 0:size].astype(np.float64) / size
    phase = rng.uniform(0.0, 2.0 * np.pi, 3)
    warp = 0.35 * np.sin(2.0 * np.pi * 1.5 * y + phase[0]) \
        + 0.1 * np.sin(2.0 * np.pi * 7.0 * y + phase[1])
    rings = 0.5 + 0.5 * np.sin(2.0 * np.pi * (14.0 * x + warp) + phase[2])
    grain = rng.normal(0.0, 0.04, (size, size)) + rng.normal(0.0, 0.03, (1, size))
    shade = np.clip(0.7 + 0.25 * rings + grain, 0.0, 1.0)
    base = np.array([0.62, 0.40, 0.22])
    rgb = np.clip(shade[..., None] * base, 0.0, 1.0)
    q = np.round(rgb * 255.0).astype(np.float32)
    return q * np.float32(1.0 / 255.0)


def theater(texture: Texture, device=None, engine=None):
    """examples/theater.py:build_scene with `texture` as the floor's wood,
    on a new flexlight_tpu_torch.FlexLight on `device`, or on `engine` (a
    FlexLight of either package with a canvas of 192 x 192; `texture` is
    then that package's Texture). Returns the engine (set `engine.canvas`
    and `engine.renderer = "pathtracer"` to render)."""
    if engine is None:
        engine = FlexLight((192, 192), device=device)
    engine.io = "web"
    camera = engine.camera
    scene = engine.scene

    scene.textures.push(texture)
    scene.standardTextureSizes = [512, 512]

    rough_tex = scene.texture_from_rme([1, 0.3, 0], 1, 1)
    smooth_tex = scene.texture_from_rme([0.4, 0.2, 0], 1, 1)
    stripes = ([[1, 0.1, 0]] * 11 + [[0, 0.5, 0]] * 10 + [[1, 0.1, 0]]
               + [[1, 0.1, 0]] * 11)
    back_mirror_tex = scene.texture_from_rme(np.array(stripes, dtype=np.float32).reshape(-1),
                                             11, 3)
    scene.pbr_textures.push(rough_tex, smooth_tex, back_mirror_tex)
    scene.translucency_textures.push(scene.texture_from_tpo([1, 0, 0.6], 1, 1))

    camera.x, camera.y, camera.z = 35, 35, -53
    camera.fx, camera.fy = 0.47, 0.44

    scene.primaryLightSources = [
        [-58.03, 26, 7.5], [-58.03, 26, -10.5],
        [43.03, 26, 0], [43.03, 26, -11.5],
        [-20, 26, -40], [-10, 26, -40], [0, 26, -40], [10, 26, -40], [20, 26, -40],
    ]
    scene.ambientLight = [0, 0, 0]
    for i in range(9):
        scene.primary_light_sources[i].intensity = 1000

    bottom_plane = scene.Plane([-43.03, 0, -28], [43.03, 0, -28],
                               [43.03, 0, 27.28], [-43.03, 0, 27.28])
    back_plane = scene.Plane([-24.5, 0, 27.28], [24.5, 0, 27.28],
                             [24.5, 22, 27.28], [-24.5, 22, 27.28])
    left_plane = scene.Plane([-43.03, 0, 0], [-24.5, 0, 27.28],
                             [-24.5, 22, 27.28], [-43.03, 22, 0])
    right_plane = scene.Plane([43.03, 0, 0], [43.03, 22, 0],
                              [24.5, 22, 27.28], [24.5, 0, 27.28])
    bottom_plane.textureNums = [0, 1, -1]
    back_plane.textureNums = [-1, 2, -1]
    left_plane.textureNums = [-1, 0, -1]
    right_plane.textureNums = [-1, 0, -1]

    cube = scene.Cuboid(-3, 3, 0, 17, 2, 8)
    cube.color = [255, 80, 120]

    scene.queue.push([bottom_plane, back_plane, left_plane, right_plane, cube])
    return engine
