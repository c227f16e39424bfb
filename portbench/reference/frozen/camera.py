"""Camera state (modules/camera.js:1-11): position, yaw/pitch, fov.

The port's own copy of flexlight_tpu/camera.py (flexlight_tpu_torch imports
nothing of the JAX package).
"""

from __future__ import annotations

import math

import numpy as np


class Camera:
    def __init__(self):
        self.x = 0.0
        self.y = 0.0
        self.z = 0.0
        self.fx = 0.0
        self.fy = 0.0
        self.fov = 1.0 / math.pi

    @property
    def position(self) -> np.ndarray:
        return np.array([self.x, self.y, self.z], dtype=np.float32)

    def view_matrix(self, width: int, height: int, jitter=(0.0, 0.0)) -> np.ndarray:
        """3x3 view matrix exactly as built per-frame by the reference
        (pathtracerWGL2.js:310-318): fov and aspect are folded in, and the
        TAA jitter perturbs the view angles."""
        dx = self.fx + jitter[0]
        dy = self.fy + jitter[1]
        inv_fov = 1.0 / self.fov
        h_over_w_fov = height * inv_fov / width
        cx, sx = math.cos(dx), math.sin(dx)
        cy, sy = math.cos(dy), math.sin(dy)
        return np.array([
            [cx * h_over_w_fov, 0.0, sx * h_over_w_fov],
            [-sx * sy * inv_fov, cy * inv_fov, cx * sy * inv_fov],
            [-sx * cy, -sy, cx * cy],
        ], dtype=np.float32)
