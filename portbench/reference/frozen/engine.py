"""Engine facade of the frozen copy: the camera, config and scene the
scene builders of `scenes` fill in. The renderers are left out: the
reference renders with `portbench/reference/renderers/`; the fly camera
is `interaction.py`."""

from __future__ import annotations

import torch

from .camera import Camera
from .config import Config
from .scene.scene import Scene


class FlexLight:
    """`FlexLight(canvas, device=...)`: holds a (width, height) canvas, the
    camera, the config and the scene on one explicit torch device."""

    def __init__(self, canvas=None, *, device):
        self.device = torch.device(device)
        self.canvas = canvas if canvas is not None else (512, 512)
        self.camera = Camera()
        self.config = Config()
        self.scene = Scene()
        self.io = "web"
