"""Engine facade (flexlight.js:13-142): holds camera / config / scene /
renderer and hot-swaps the renderer by string key, with the properties of
flexlight_tpu/engine.py, building the port's renderers on one explicit
torch device."""

from __future__ import annotations

import torch

from .camera import Camera
from .config import Config
from .scene.scene import Scene


class FlexLight:
    """`FlexLight(canvas, device=...)`: `canvas` is a (width, height) tuple
    or None (512 x 512). The renderer, built on `device`, is the Rasterizer
    by default (flexlight.js:34); `renderer = "pathtracer"` gives the
    PathTracer, and `api = "simple"` or "webgpu" the SimplePathTracer for
    either name (flexlight_tpu/engine.py:125-139)."""

    def __init__(self, canvas=None, *, device):
        self.device = torch.device(device)
        self._api = "tpu"
        self._canvas = canvas if canvas is not None else (512, 512)
        self._camera = Camera()
        self._config = Config()
        self._scene = Scene()
        self._renderer_name = "rasterizer"  # flexlight.js:34 defaults to rasterizer
        self._renderer = None
        self._io_name = "web"
        self._io = None
        self._ui = None

    # --- properties mirroring flexlight.js:39-104 ---
    @property
    def canvas(self):
        return self._canvas

    @canvas.setter
    def canvas(self, value):
        self._canvas = value
        self._renderer = None

    @property
    def api(self):
        return self._api

    @api.setter
    def api(self, value):
        if value not in ("tpu", "simple", "webgl2", "webgpu"):
            raise ValueError(f"unknown api {value!r}")
        self._api = value
        self._renderer = None

    @property
    def camera(self):
        return self._camera

    @camera.setter
    def camera(self, camera):
        self._camera = camera
        self._scene.camera = camera  # flexlight.js:96 mirrors it onto the scene
        if self._renderer is not None:
            self._renderer.camera = camera

    @property
    def config(self):
        return self._config

    @config.setter
    def config(self, config):
        self._config = config
        if self._renderer is not None:
            self._renderer.config = config

    @property
    def scene(self):
        return self._scene

    @scene.setter
    def scene(self, scene):
        self._scene = scene
        self._renderer = None

    @property
    def ui(self):
        """Center-ray object picker (modules/ui.js), tracking the current
        scene and camera."""
        if self._ui is None:
            from .interaction import UI

            self._ui = UI(self._scene, self._camera)
        self._ui.scene = self._scene
        self._ui.camera = self._camera
        return self._ui

    @property
    def io(self):
        if self._io is None:
            from .interaction import WebIo

            self._io = WebIo(self.renderer, self._camera)
        return self._io

    @io.setter
    def io(self, value):
        if value != "web":
            raise ValueError(f"Io option {value!r} doesn't exist.")
        self._io_name = value
        self._io = None

    @property
    def renderer(self):
        if self._renderer is None:
            self._renderer = self._make_renderer(self._renderer_name)
        return self._renderer

    @renderer.setter
    def renderer(self, name):
        """Hot-swap by string key (flexlight.js:106-129)."""
        if self._renderer is not None:
            self._renderer.halt()
        self._renderer_name = name
        self._renderer = self._make_renderer(name)

    def _make_renderer(self, name: str):
        from .models.pathtracer import PathTracer
        from .models.rasterizer import Rasterizer
        from .models.simple import SimplePathTracer

        width, height = self._canvas
        args = (width, height, self._scene, self._camera, self._config, self.device)
        # the 'webgpu' api maps both renderer names to the simple pipeline
        # (flexlight.js:115-123: rasterizer + webgpu -> PathTracerWGPU)
        if self._api in ("webgpu", "simple"):
            return SimplePathTracer(*args)
        if name == "pathtracer":
            return PathTracer(*args)
        if name == "rasterizer":
            return Rasterizer(*args)
        raise ValueError(f"Renderer option {name!r} on api {self._api!r} doesn't exist.")
