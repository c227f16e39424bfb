"""FlexLight's theater example (examples/theater.js: 20 triangles, 9
lights, a wood-textured floor), on both sides. Its floor texture
textures/holz.jpg is not in the repository: both sides take the 512x512
stand-in made from the configuration's `assets_seed`. A static scene."""


def build_program(cfg: dict, device, tmpdir: str):
    """(the program's engine, animate(call) or None)."""
    from flexlight_tpu_torch import scenes

    return scenes.theater(scenes.stand_in_wood_texture(cfg["assets_seed"]), device=device), None


def build_reference(cfg: dict, device, tmpdir: str):
    """(the frozen copy's engine, at(frame) or None)."""
    from portbench.reference.frozen import scenes

    return scenes.theater(scenes.stand_in_wood_texture(cfg["assets_seed"]), device=device), None
