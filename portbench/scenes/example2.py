"""FlexLight's many-lights stress scene (examples/example2.js: five
cuboids over a plane, 64 light slots, slot 1 empty at the start), on both
sides. Before each frame the example's animate fills slot 1 with a light
orbiting at radius 20, moves the first cuboid's vertices by 0.05 sin(t)
along x and rebuilds the renderer's scene buffers, so the geometry and
the lights change every frame. It needs no asset."""

import copy
import math
import random


def build_program(cfg: dict, device, tmpdir: str):
    """(the program's engine, animate(call))."""
    from flexlight_tpu_torch import scenes

    return scenes.example2(device=device)


def _scene(engine):
    """examples/example2.py:build_scene on the frozen copy's engine: the
    list of cuboids whose first one the animation moves."""
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

    scene.queue.push(this_plane, objects)
    return r


def build_reference(cfg: dict, device, tmpdir: str):
    """(the frozen copy's engine, at(frame)): at(frame) puts the scene in
    the state after the animation's calls 0 .. frame, replayed from the
    start state, so that the accumulated moves and the orbit's angle are
    the program's bit for bit, whatever order the frames come in."""
    from portbench.reference.frozen.engine import FlexLight
    from portbench.reference.frozen.scene.scene import LightSource

    engine = FlexLight((192, 192), device=device)
    scene = engine.scene
    r = _scene(engine)
    start = (copy.deepcopy(r[0]), scene.primary_light_sources[1])
    state = {"calls": 0, "iterator": 0.0}

    def animate():
        state["iterator"] += 0.01
        s, c = math.sin(state["iterator"]), math.cos(state["iterator"])
        scene.primary_light_sources[1] = LightSource([20 * s, 8, 20 * c], intensity=10)
        r[0].move(0.05 * s, 0, 0)
        state["calls"] += 1

    def at(frame: int):
        if state["calls"] > frame + 1:
            r[0] = copy.deepcopy(start[0])
            scene.primary_light_sources[1] = start[1]
            state.update(calls=0, iterator=0.0)
        while state["calls"] < frame + 1:
            animate()

    return engine, at
