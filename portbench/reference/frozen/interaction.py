"""Fly camera (modules/io.js:14-107): a frozen copy of
flexlight_tpu_torch/interaction.py's WebIo, the integration of held keys
and mouse moves into the camera. Every call takes its time explicitly."""

from __future__ import annotations

import math

# key -> signed axis (io.js:5-12)
TRANSLATION_MAP = {
    "right": 1, "left": -1,
    "down": -2, "up": 2,
    "backward": -3, "forward": 3,
}

DEFAULT_KEYMAP = {
    "KeyW": "forward", "KeyA": "left", "KeyS": "backward", "KeyD": "right",
    "Space": "up", "ShiftLeft": "down",
}


class WebIo:
    """Time-integrated fly camera (io.js:14-107). Drive it with
    key_down/key_up/mouse_move + update(now_ms)."""

    def __init__(self, camera, now_ms: float):
        self.camera = camera
        self.mouse_x = 4.0
        self.mouse_y = 2.0
        self.movement_speed = 0.01
        self._key_map = {k: TRANSLATION_MAP[v] for k, v in DEFAULT_KEYMAP.items()}
        self._pressed = {k: False for k in self._key_map}
        self._movement = [0.0, 0.0, 0.0]
        self._saved_time = now_ms

    def _update_movement(self, value: int):
        self._movement[abs(value) - 1] += math.copysign(1, value)

    def key_down(self, key: str, now_ms: float):
        if key in self._pressed and not self._pressed[key]:
            self.update(now_ms)
            self._pressed[key] = True
            self._update_movement(self._key_map[key])

    def key_up(self, key: str, now_ms: float):
        if key in self._pressed and self._pressed[key]:
            self.update(now_ms)
            self._pressed[key] = False
            self._update_movement(-self._key_map[key])

    def update(self, now_ms: float):
        """Integrate movement into the camera (io.js:51-59)."""
        c = self.camera
        diff = (now_ms - self._saved_time) * self.movement_speed
        c.x += diff * (self._movement[0] * math.cos(c.fx) - self._movement[2] * math.sin(c.fx))
        c.y += diff * self._movement[1]
        c.z += diff * (self._movement[2] * math.cos(c.fx) + self._movement[0] * math.sin(c.fx))
        self._saved_time = now_ms

    def mouse_move(self, dx: float, dy: float, width: int, height: int):
        """Mouse-look with fy clamped to +-pi/2 (io.js:99-105)."""
        mx = self.mouse_x / width * dx
        my = self.mouse_y / height * dy
        self.camera.fx -= mx
        if 2.0 * abs(self.camera.fy + my) < math.pi:
            self.camera.fy += my
