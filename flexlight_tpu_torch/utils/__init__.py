"""Host utilities: the port's own copies of flexlight_tpu/utils/mathlib.py
and metrics.py."""

from . import mathlib
