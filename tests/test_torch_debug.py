"""utils.debug's NaN / Inf guard, on its own and in each renderer's frame.

Debug mode is off unless set_debug(True) turns it on; every test here
turns it off again. A NaN is planted in a renderer's TAA history (which
the next frame's average carries into the display) or in its first
light (which reaches the display through the shading), and the frame
must raise FloatingPointError naming the renderer's check with debug on
and render without a check with debug off."""

import math

import numpy as np
import pytest
import torch

import flexlight_tpu_torch as port
from flexlight_tpu_torch.post.taa import TAAState
from flexlight_tpu_torch.utils import debug
from tests.test_torch_scene_copy import build


@pytest.fixture
def debug_mode():
    """set_debug, restored to off whatever the test does."""
    yield debug.set_debug
    debug.set_debug(False)


def test_assert_finite_checks_only_in_debug_mode(debug_mode):
    display = torch.zeros(4, 5, 3)
    display[2, 1, 0] = math.nan
    history = torch.zeros(9, 4, 5, 4)
    history[3, 0, 0, 2] = math.inf
    clean = (torch.ones(4, 5, 3), TAAState(history=torch.zeros(9, 4, 5, 4)), None,
             torch.tensor([1, -1], dtype=torch.int32))
    assert not debug.debug_enabled()
    debug.assert_finite((display, TAAState(history=history)), "off")   # no check when off
    debug_mode(True)
    assert debug.debug_enabled()
    debug.assert_finite(clean, "clean")   # None leaves and integer tensors are skipped
    with pytest.raises(FloatingPointError, match=r"in frame\[leaf 0\]: 1 elements"):
        debug.assert_finite((display, TAAState(history=history)), "frame")
    with pytest.raises(FloatingPointError, match=r"in frame\[leaf 1\]: 1 elements "
                                                 r"\(shape \(9, 4, 5, 4\)\)"):
        debug.assert_finite((torch.ones(4, 5, 3), TAAState(history=history)), "frame")
    debug_mode(False)
    debug.assert_finite((display, TAAState(history=history)), "off again")


def _renderer(name, antialiasing):
    e = port.FlexLight((8, 6), device="cpu")
    e.scene, e.camera = build("cornell", port)
    e.config = port.Config(temporal=False, filter=False, antialiasing=antialiasing)
    if name == "simple":
        e.api = "simple"
    else:
        e.renderer = name
    return e.renderer


def _plant(renderer, where):
    if where == "taa_history":
        renderer._taa_state.history[2, 3, 4, 1] = math.nan
    else:
        renderer._buffers.lights[0, 0, 0] = math.nan


@pytest.mark.parametrize("name,antialiasing,where,check", [
    ("rasterizer", "taa", "taa_history", "rasterizer.frame"),
    ("rasterizer", "fxaa", "light", "rasterizer.frame"),
    ("pathtracer", "taa", "taa_history", "pathtracer.frame"),
    ("pathtracer", "fxaa", "light", "pathtracer.frame"),
    ("simple", None, "light", "simple.frame"),
])
def test_a_renderer_checks_its_frame_in_debug_mode(debug_mode, name, antialiasing, where,
                                                   check):
    r = _renderer(name, antialiasing)
    debug_mode(True)
    assert np.isfinite(r.render_frame()).all()   # a clean frame passes the check
    _plant(r, where)
    debug_mode(False)
    assert not np.isfinite(r.render_frame()).all()   # the NaN reaches the display, unchecked
    _plant(r, where)
    debug_mode(True)
    with pytest.raises(FloatingPointError, match=rf"non-finite values in {check}\[leaf 0\]"):
        r.render_frame()
