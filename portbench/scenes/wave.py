"""FlexLight's wave example (examples/wave.js: a grid of cuboid pillars
bobbing through their own transforms over a plane), on both sides, at
the default side length 2. The program's animate moves every pillar one
step before each render call; the reference puts the pillars where the
example's animate has them after frame n + 1 steps."""

import math

SIDE = 2            # scenes.wave's default side length
STEP = 0.015        # the example's time step a frame


def build_program(cfg: dict, device, tmpdir: str):
    """(the program's engine, animate(call))."""
    from flexlight_tpu_torch import scenes

    return scenes.wave(SIDE, device=device)


def build_reference(cfg: dict, device, tmpdir: str):
    """(the frozen copy's engine, at(frame)): the pillars in the queue
    after the plane, row by row, as the example pushes them."""
    from portbench.reference.frozen import scenes

    engine, _ = scenes.wave(SIDE, device=device)
    pillars = [p.transform for p in list(engine.scene.queue)[1:]]

    def at(frame: int):
        t = 0.0
        for _ in range(frame + 1):   # summed as the example sums it
            t += STEP
        for k, transform in enumerate(pillars):
            i, j = divmod(k, SIDE)
            transform.move(0, 0.1 + math.sin(t + i * 0.5 + j), 0)

    return engine, at
