"""FlexLight on PyTorch: the path tracer's frame with hand-written Hopper
kernels.

A port of ``flexlight_tpu`` (JAX + Pallas). The jax-free layer of that
package (scene graph, camera, config, math utilities) is shared by import;
everything that touches the device is written again here on torch tensors,
and every Pallas kernel on the ported path is a CUDA C++ kernel under
``csrc/``. Entry points take an explicit ``device``; nothing probes for a
card and nothing falls back to the CPU. On CPU tensors each kernel wrapper
runs its plain PyTorch version, which is what the CPU tests hold against
the JAX package.
"""

from flexlight_tpu.camera import Camera
from flexlight_tpu.config import Config
from flexlight_tpu.scene.scene import LightSource, Scene, Texture
from flexlight_tpu.scene.transform import reset_global_registry

from .engine import FlexLight

__all__ = ["Camera", "Config", "FlexLight", "LightSource", "Scene", "Texture",
           "reset_global_registry"]
