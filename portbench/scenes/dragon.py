"""FlexLight's dragon example (examples/dragon.js: a glass dragon, a
metallic monkey head, a glass sphere on a metal plane), on both sides.
Its OBJ files are not in the repository: stand-ins of the published
counts (44,890 triangles) made from the configuration's `assets_seed`,
written under `tmpdir` (each side its own copy; the reference reads them
with its Python parser). Before each frame the example's animate turns
the monkey head to face the camera (dragon.js:97-119)."""

import os


def build_program(cfg: dict, device, tmpdir: str):
    """(the program's engine, animate(call))."""
    from flexlight_tpu_torch import scenes

    return scenes.dragon(cfg["assets_seed"], os.path.join(tmpdir, "program"), device=device)


def build_reference(cfg: dict, device, tmpdir: str):
    """(the frozen copy's engine, at(frame)): the head faces the camera's
    pose of that frame."""
    from portbench.reference.frozen import scenes

    return scenes.dragon(cfg["assets_seed"], os.path.join(tmpdir, "reference"),
                         device=device, fast=False)
