"""FlexLight's Cornell box (examples/cornell.js: the red / green box, two
cuboids, one light, a PBR checker texture made in code), on both sides.
A static scene; it needs no asset file."""


def build_program(cfg: dict, device, tmpdir: str):
    """(the program's engine, None)."""
    from flexlight_tpu_torch import scenes

    return scenes.cornell((cfg["width"], cfg["height"]), device=device), None


def build_reference(cfg: dict, device, tmpdir: str):
    """(the frozen copy's engine, None)."""
    from portbench.reference.frozen import scenes

    return scenes.cornell((cfg["width"], cfg["height"]), device=device), None
