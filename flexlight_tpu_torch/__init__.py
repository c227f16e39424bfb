"""FlexLight on PyTorch: the path tracer's frame with hand-written Hopper
kernels.

A port of ``flexlight_tpu`` (JAX + Pallas) that imports nothing of it: the
jax-free layer of that package (scene graph, camera, config, math and
metrics utilities) is copied here under the same relative names, and
everything that touches the device is written again on torch tensors,
with every Pallas kernel on the ported path a CUDA C++ kernel under
``csrc/``. Entry points take an explicit ``device``; nothing probes for a
card and nothing falls back to the CPU. On CPU tensors each kernel wrapper
runs its plain PyTorch version, which is what the CPU tests hold against
the JAX package.
"""

from .camera import Camera
from .config import Config
from .engine import FlexLight
from .scene.scene import LightSource, Scene, Texture
from .scene.transform import reset_global_registry

__all__ = ["Camera", "Config", "FlexLight", "LightSource", "Scene", "Texture",
           "reset_global_registry"]
