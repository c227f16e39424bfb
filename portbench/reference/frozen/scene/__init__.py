"""The scene graph, transforms and flattening: the port's own copy of
flexlight_tpu/scene."""

from .flatten import FlattenedScene, flatten_graph
from .primitives import Bounding, Cuboid, Object3D, Plane, Primitive, Triangle
from .scene import LightSource, PushList, Scene, Texture
from .transform import Transform, TransformRegistry, reset_global_registry
