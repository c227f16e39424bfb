"""Host utilities: the port's own copies of flexlight_tpu/utils/mathlib.py,
metrics.py, image.py, glpack.py and settings.py, and the runtime utilities
(checkpoint, timing, failover) on torch."""

from . import mathlib
