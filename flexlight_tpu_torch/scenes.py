"""Scenes of the port's slice.

`cornell` is examples/cornell.py's build_scene line for line (the port of
the reference's examples/cornell.js; its checker texture is made in code,
so it needs no asset file), the default scene of the frame server
(`python -m flexlight_tpu_torch.serve cornell`).

`theater` is examples/theater.py's build_scene line for line (the port of
the reference's examples/theater.js: 9 lights, wood-textured floor,
striped metallic back mirror), on the port's engine, taking the floor
texture as an argument: the original loads textures/holz.jpg, which this
repository does not carry. `stand_in_wood_texture` makes a stand-in of the
same size from a seed. Given another engine (`engine=`, such as
flexlight_tpu's FlexLight), `theater` builds the same scene with that
engine's own classes, so a test can flatten both packages' scenes.

`wave` is examples/wave.py's build_scene line for line (the port of the
reference's examples/wave.js: a grid of cuboid pillars bobbing through
their own transforms, over a plane with a 1x1 PBR texture; 50 triangles
and one light at the default side length), with its `animate`.

`dragon` is examples/dragon.py's build_scene line for line (the port of
the reference's examples/dragon.js: a glass dragon, a metallic monkey
head that turns to face the camera, a glass sphere, on a metallic plane).
Its three OBJ files (objects/dragon_lp.obj, monke_smooth.obj, sphere.obj)
are not in this repository either: `dragon_stand_in_objs` writes seeded
stand-ins with the same triangle counts as the scene the examples render
(44,890 drawable triangles, 43,600 of them the dragon): closed,
noise-displaced UV spheres with smooth vertex normals.

`example2` is examples/example2.py's build_scene line for line (the port
of the reference's examples/example2.js, the many-lights stress scene:
five cuboids over a plane, 64 light slots of which slot 1 starts empty),
with its `animate`, which fills slot 1 with an orbiting light, moves a
cuboid's vertices and rebuilds the renderer's scene buffers every frame.
"""

from __future__ import annotations

import math
import os
import random

import numpy as np

from .engine import FlexLight
from .scene.scene import Texture
from .utils import mathlib

# (file, longitude segments, latitude rings, axis scale, lift, noise amplitude):
# a UV sphere of 2 * segments * (rings - 1) triangles
STAND_IN_MESHES = (
    ("dragon_lp.obj", 200, 110, (9.0, 5.0, 4.0), 5.0, 0.18),   # 43,600 triangles
    ("monke_smooth.obj", 22, 23, (1.0, 0.85, 0.9), 0.0, 0.08),  # 968
    ("sphere.obj", 16, 11, (1.0, 1.0, 1.0), 0.0, 0.0),          # 320
)


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


def cornell(size=(256, 256), device=None, engine=None):
    """examples/cornell.py:build_scene line for line (the reference's
    examples/cornell.js: the red / green box, two cuboids, one light, the
    PBR checker texture made in code) on a new
    flexlight_tpu_torch.FlexLight of `size` on `device`, or on `engine` (a
    FlexLight of either package). Returns the engine."""
    if engine is None:
        engine = FlexLight(size, device=device)
    engine.io = "web"

    camera = engine.camera
    scene = engine.scene

    # PBR checker texture (cornell.js:18-31)
    tile = np.zeros((128, 128, 3), dtype=np.float32)
    a = np.array([1, 0, 0.4], dtype=np.float32)
    b = np.array([0.1, 1, 0], dtype=np.float32)
    tile[:64, :64] = a
    tile[:64, 64:] = b
    tile[64:, :64] = b
    tile[64:, 64:] = a
    caro_tex = scene.texture_from_rme(tile.reshape(-1), 128, 128)
    scene.pbr_textures.push(caro_tex)
    scene.standardTextureSizes = [128, 128]

    camera.z = -20
    scene.primaryLightSources = [[0, 4, 0]]
    scene.primaryLightSources[0].intensity = 160

    bottom_plane = scene.Plane([-5, -5, -21], [5, -5, -21], [5, -5, 5], [-5, -5, 5])
    top_plane = scene.Plane([-5, 5, -21], [-5, 5, 5], [5, 5, 5], [5, 5, -21])
    back_plane = scene.Plane([-5, -5, 5], [5, -5, 5], [5, 5, 5], [-5, 5, 5])
    front_plane = scene.Plane([-5, -5, -21], [-5, 5, -21], [5, 5, -21], [5, -5, -21])
    left_plane = scene.Plane([-5, -5, -21], [-5, -5, 5], [-5, 5, 5], [-5, 5, -21])
    right_plane = scene.Plane([5, -5, -21], [5, 5, -21], [5, 5, 5], [5, -5, 5])

    for item in [bottom_plane, top_plane, back_plane, front_plane, left_plane, right_plane]:
        item.color = [230, 230, 230]
    left_plane.color = [220, 0, 0]
    right_plane.color = [0, 150, 0]

    cube = [None, None]
    cube[0] = engine.scene.Cuboid(-3, -1.5, -5, -2, -1, 1)
    cube[0].textureNums = [-1, 0, -1]
    x, x2, y, y2, z, z2 = 0, 3, -5, -1, -1, 2
    cube[1] = scene.Cuboid(0, 3, -5, -1, -1, 2)
    b0, b1, b2, b3 = [x + 1, y, z], [x2, y, z + 1], [x2 - 1, y, z2], [x, y, z2 - 1]
    t0, t1, t2, t3 = [x + 1, y2, z], [x2, y2, z + 1], [x2 - 1, y2, z2], [x, y2, z2 - 1]
    cube[1][0] = scene.Plane(t0, t1, t2, t3, [0, 1, 0])
    cube[1][1] = scene.Plane(t1, b1, b2, t2, [1, 0, 0])
    cube[1][2] = scene.Plane(t2, b2, b3, t3, [0, 0, 1])
    cube[1][3] = scene.Plane(b3, b2, b1, b0, [0, -1, 0])
    cube[1][4] = scene.Plane(t3, b3, b0, t0, [-1, 0, 0])
    cube[1][5] = scene.Plane(t0, b0, b1, t1, [0, 0, -1])

    box = [bottom_plane, top_plane, back_plane, front_plane, left_plane, right_plane]
    scene.queue.push(cube, box)
    return engine


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


def wave(side_length: int = 2, device=None, engine=None):
    """examples/wave.py:build_scene on a new flexlight_tpu_torch.FlexLight
    on `device`, or on `engine` (a FlexLight of either package with a
    canvas of 192 x 192). Returns (engine, animate): `animate(frame)`
    moves every pillar one step of its bobbing (wave.js)."""
    if engine is None:
        engine = FlexLight((192, 192), device=device)
    engine.io = "web"
    camera = engine.camera
    scene = engine.scene

    normal_tex = scene.texture_from_rme([0.7, 1, 0], 1, 1)
    cuboid_tex = scene.texture_from_rme([0.1, 0, 0.02], 1, 1)
    scene.pbr_textures.push(normal_tex, cuboid_tex)
    scene.translucency_textures.push(scene.texture_from_tpo([0, 0, 1.3 / 4], 1, 1))
    scene.standardTextureSizes = [1, 1]

    scene.primaryLightSources = [[-1, 10, -1]]
    scene.primary_light_sources[0].intensity = 1000

    this_plane = scene.Plane([-100, -1, -100], [100, -1, -100], [100, -1, 100],
                             [-100, -1, 100])
    this_plane.textureNums = [-1, 0, -1]
    scene.queue.push(this_plane)

    camera.x, camera.y, camera.z = 4 + side_length, side_length + 2, 4 + side_length
    camera.fx, camera.fy = 0.75 * math.pi, 0.6

    random.seed(0)
    transforms = []
    for i in range(side_length):
        row = []
        for j in range(side_length):
            transform = scene.Transform()
            cuboid = scene.Cuboid(i, i + 1, 0, 3.1, j, j + 1)
            cuboid.transform = transform
            cuboid.color = [random.random() * 255, random.random() * 255,
                            random.random() * 255]
            cuboid.roughness = 0.5
            scene.queue.push(cuboid)
            row.append(transform)
        transforms.append(row)

    engine.renderer = "pathtracer"

    state = {"t": 0.0}

    def animate(_frame):
        state["t"] += 0.015
        for i in range(side_length):
            for j in range(side_length):
                transforms[i][j].move(0, 0.1 + math.sin(state["t"] + i * 0.5 + j), 0)

    return engine, animate


def stand_in_mesh(rng: np.random.Generator, segments: int, rings: int, scale, lift: float,
                  amplitude: float):
    """A closed UV sphere displaced by seeded smooth noise: (vertices [V, 3],
    smooth vertex normals [V, 3], triangles [F, 3] of 1-based indices),
    F = 2 * segments * (rings - 1). The poles are single vertices."""
    theta = np.pi * np.arange(1, rings) / rings                 # latitude circles
    phi = 2.0 * np.pi * np.arange(segments) / segments
    st, ct = np.sin(theta)[:, None], np.cos(theta)[:, None]
    ring = np.stack([st * np.cos(phi), np.broadcast_to(ct, (rings - 1, segments)),
                     st * np.sin(phi)], axis=-1).reshape(-1, 3)
    unit = np.concatenate([[[0.0, 1.0, 0.0]], ring, [[0.0, -1.0, 0.0]]])
    # smooth noise: a sum of random plane waves over the unit direction
    freq = rng.normal(0.0, 2.5, (12, 3))
    phase = rng.uniform(0.0, 2.0 * np.pi, 12)
    weight = rng.uniform(0.5, 1.0, 12) / 12.0 ** 0.5
    radius = 1.0 + amplitude * (np.sin(unit @ freq.T + phase) * weight).sum(axis=1)
    verts = unit * radius[:, None] * np.asarray(scale) + np.array([0.0, lift, 0.0])

    south = len(unit) - 1
    tris = []
    for j in range(segments):
        k = (j + 1) % segments
        tris.append((0, 1 + k, 1 + j))                          # north fan
        for r in range(rings - 2):
            a, b = 1 + r * segments + j, 1 + r * segments + k
            c, d = a + segments, b + segments
            tris += [(a, b, d), (a, d, c)]
        base = 1 + (rings - 2) * segments
        tris.append((south, base + j, base + k))                # south fan
    tris = np.asarray(tris, dtype=np.int64)

    e1 = verts[tris[:, 1]] - verts[tris[:, 0]]
    e2 = verts[tris[:, 2]] - verts[tris[:, 0]]
    face_n = np.cross(e1, e2)                                   # area-weighted
    normals = np.zeros_like(verts)
    for c in range(3):
        np.add.at(normals, tris[:, c], face_n)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    return verts, normals, tris + 1


def dragon_stand_in_objs(seed: int, directory) -> dict:
    """Write the three seeded stand-in OBJ files of the dragon scene into
    `directory` (created if missing); returns {file name: path}. The same
    seed writes the same bytes."""
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = {}
    for name, segments, rings, scale, lift, amplitude in STAND_IN_MESHES:
        path = os.path.join(directory, name)
        write_obj(path, *stand_in_mesh(rng, segments, rings, scale, lift, amplitude),
                  comment=f"seeded stand-in for objects/{name} (seed {seed})")
        paths[name] = path
    return paths


def write_obj(path, verts, normals, tris, comment: str = "") -> None:
    """An OBJ file of vertices, vertex normals and triangles (1-based
    indices, each vertex with its own normal)."""
    lines = [f"# {comment}"] if comment else []
    lines += [f"v {x:.7g} {y:.7g} {z:.7g}" for x, y, z in verts]
    lines += [f"vn {x:.7g} {y:.7g} {z:.7g}" for x, y, z in normals]
    lines += [f"f {a}//{a} {b}//{b} {c}//{c}" for a, b, c in tris]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def dragon(seed: int, directory, device=None, engine=None, fast: bool | None = None):
    """examples/dragon.py:build_scene with the stand-in OBJ files of
    `dragon_stand_in_objs(seed, directory)`, on a new
    flexlight_tpu_torch.FlexLight on `device`, or on `engine` (a FlexLight
    of either package with a canvas of 192 x 192). `fast` is passed to
    every `import_obj` (default: the native loader where it builds).
    Returns (engine, animate): `animate(t)` turns the monkey head to face
    the camera (dragon.js:97-119)."""
    objs = dragon_stand_in_objs(seed, directory)
    if engine is None:
        engine = FlexLight((192, 192), device=device)
    engine.io = "web"
    camera = engine.camera
    scene = engine.scene

    camera.x, camera.y, camera.z = -10, 14, -10
    camera.fx, camera.fy = -0.9, 0.45

    scene.primaryLightSources = [[50, 70, 50]]
    scene.primary_light_sources[0].intensity = 50000
    scene.primary_light_sources[0].variation = 10
    scene.ambientLight = [0.1, 0.1, 0.1]

    plane = scene.Plane([-500, -1, -500], [500, -1, -500], [500, -1, 500], [-500, -1, 500])
    plane.roughness = 1
    plane.metallicity = 0.8
    scene.queue.push(plane)

    dragon_transform = scene.Transform()
    dragon_transform.move(15, 0, 15)
    dragon_transform.scale(0.5)
    obj = scene.import_obj(objs["dragon_lp.obj"], fast=fast)
    obj.transform = dragon_transform
    obj.roughness = 0
    obj.metallicity = 1
    obj.translucency = 1
    obj.ior = 1.5
    obj.color = [255, 100, 100]
    scene.queue.push(obj)

    monke_transform = scene.Transform()
    monke_transform.move(5, 1, 12)
    monke_transform.scale(2)
    monke = scene.import_obj(objs["monke_smooth.obj"], fast=fast)
    monke.transform = monke_transform
    monke.roughness = 0.1
    monke.metallicity = 1
    monke.color = [255, 200, 100]
    scene.queue.push(monke)

    sphere = scene.import_obj(objs["sphere.obj"], fast=fast)
    sphere.scale(4)
    sphere.move(15, 3, 0)
    sphere.metallicity = 1
    sphere.roughness = 0
    sphere.translucency = 1
    sphere.ior = 1.5
    scene.queue.push(sphere)

    scene.queue[:] = [scene.generate_bvh()]
    engine.renderer = "pathtracer"
    engine.renderer.update_scene()

    def animate(_t):
        # Look-at-camera spherical rotation (dragon.js:97-119)
        diff = mathlib.diff([camera.x, camera.y, camera.z], monke_transform.position)
        r = mathlib.length(diff)
        theta = (math.copysign(1, diff[2])
                 * math.acos(diff[0] / math.sqrt(diff[0] ** 2 + diff[2] ** 2))
                 - math.pi * 0.5)
        psi = math.acos(diff[1] / r) - math.pi * 0.5
        monke_transform.rotate_spherical(theta, psi)

    return engine, animate


def example2(device=None, engine=None):
    """examples/example2.py:build_scene on a new flexlight_tpu_torch.FlexLight
    on `device`, or on `engine` (a FlexLight of either package with a canvas
    of 192 x 192). Returns (engine, animate): `animate(frame)` runs the
    example's body (example2.js): slot 1 becomes a light orbiting at radius
    20, the first cuboid moves by 0.05 sin(t) along x, and the renderer the
    engine holds at that call rebuilds its scene buffers (update_scene)."""
    if engine is None:
        engine = FlexLight((192, 192), device=device)
    engine.io = "web"
    camera = engine.camera
    scene = engine.scene

    normal_tex = scene.texture_from_rme([0.3, 1, 0], 1, 1)
    scene.pbr_textures.push(normal_tex)
    scene.standardTextureSizes = [1, 1]

    camera.x, camera.y, camera.z = -12, 5, -18
    camera.fx, camera.fy = -0.440, 0.235

    this_plane = scene.Plane([-100, -1, -100], [100, -1, -100],
                             [100, -1, 100], [-100, -1, 100], [0, 1, 0])
    this_plane.textureNums = [-1, -1, -1]
    r = [
        scene.Cuboid(-1.5, 4.5, -1, 2, 1.5, 2.5),
        scene.Cuboid(-1.5, 1.5, -1, 2, -2, -1),
        scene.Cuboid(0.5, 1.5, -1, 2, -1, 0),
        scene.Cuboid(-1.5, -0.5, -1, 2, -1, 0),
    ]
    random.seed(0)
    for cuboid in r:
        cuboid.color = [random.random() * 255, random.random() * 255, random.random() * 255]
        cuboid.textureNums = [-1, 0, -1]
    cube = scene.Cuboid(5.5, 6.5, 1.5, 2.5, 5.5, 6.5)
    objects = [r, cube]

    lights = [None] * 64
    lights[0] = [0, 10, 0]
    lights[2] = [10, 30, 10]
    lights[3] = [-10, 30, 10]
    lights[4] = [10, 30, -10]
    lights[5] = [-10, 30, -10]
    lights[6] = [30, 30, 30]
    lights[7] = [-30, 30, -30]
    for i in range(8, 64):
        lights[i] = [-300 + i * 10, 300, -300]
    scene.primaryLightSources = lights
    scene.primary_light_sources[0].intensity = 50
    for i in range(2, 8):
        scene.primary_light_sources[i].intensity = 200
    for i in range(8, 64):
        scene.primary_light_sources[i].intensity = 50
    light_source = type(scene.primary_light_sources[0])   # the engine package's LightSource

    scene.queue.push(this_plane, objects)
    engine.renderer = "pathtracer"

    state = {"iterator": 0.0}

    def animate(_frame):
        state["iterator"] += 0.01
        s, c = math.sin(state["iterator"]), math.cos(state["iterator"])
        scene.primary_light_sources[1] = light_source([20 * s, 8, 20 * c], intensity=10)
        r[0].move(0.05 * s, 0, 0)
        engine.renderer.update_scene()  # vertices moved -> re-flatten

    return engine, animate
