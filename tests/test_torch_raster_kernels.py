"""The rasterizer's shading kernels (csrc/raster.cu: raster_surface,
raster_rays, raster_shade), compiled for the host (-DFL_EMULATE, as in
test_torch_kernels_emulated.py) and launched through the same Python
launch code as on the card, against their plain versions
(ops/raster_kernel.py) on the inputs of every call of a 24x16 theater
frame with its 4 translucent layers: identical, bit for bit.

As there, the host's libm is not torch's CPU kernels: the plain versions
take a correctly rounded square root (`exact_sqrt`, as the card's sqrtf
is) and the C library's powf for the gamma curve (`host_pow`, which the
emulated kernel calls). On the card, tests/test_torch_cuda.py and
chip_smoke.py hold the kernels against the plain versions as they are."""

import ctypes
import ctypes.util

import numpy as np
import pytest
import torch

from flexlight_tpu_torch import Config, Texture
from flexlight_tpu_torch.kernels import PLAIN
from flexlight_tpu_torch.models.rasterizer import Rasterizer
from flexlight_tpu_torch.ops import raster_kernel as RK
from flexlight_tpu_torch.scenes import stand_in_wood_texture, theater
from tests.test_torch_kernels_emulated import _clone, exact_sqrt, lib, pytestmark  # noqa: F401

NAMES = ("raster_surface", "raster_rays", "raster_shade")
CASES = ("theater", "dark_light", "tpo_atlas")
LAYERS, LIGHTS = 4, 9


@pytest.fixture
def host_pow(monkeypatch):
    """The C library's powf, which the emulated kernel calls, as torch.pow
    of a float32 tensor to a float exponent (reinhard_gamma's only call)."""
    powf = ctypes.CDLL(ctypes.util.find_library("m")).powf
    powf.restype, powf.argtypes = ctypes.c_float, [ctypes.c_float, ctypes.c_float]
    monkeypatch.setattr(torch, "pow", lambda x, e: torch.tensor(
        [powf(a, e) for a in x.reshape(-1).tolist()], dtype=torch.float32).reshape(x.shape))


def _rasterizer(case: str, kernels):
    """theater at 24x16 (4 translucent layers, 9 lights, FXAA) on the
    kernel scheme. "dark_light": light 3 is off (strength 0);
    "tpo_atlas": a seeded 4x2 translucency texture on the left wall and
    the floor, so their TPO comes from the atlas's second tile."""
    e = theater(stand_in_wood_texture(0), device="cpu")
    if case == "tpo_atlas":
        rng = np.random.default_rng(11)
        e.scene.translucency_textures.push(
            Texture(rng.uniform(0, 1, (2, 4, 3)).astype(np.float32)))
        planes = e.scene.queue[0]
        planes[0].textureNums = [0, 1, 1]
        planes[2].textureNums = [-1, 0, 1]
    r = Rasterizer(24, 16, e.scene, e.camera, Config(), "cpu", kernels=kernels)
    if case == "dark_light":
        r.update_scene()
        lights = r._buffers.lights.clone()
        lights[3, 1, 0] = 0.0
        r._buffers = r._buffers._replace(lights=lights)
    return r


def _calls(case: str):
    """The inputs of every shading-kernel call of the case's frame with the
    plain versions, recorded before each call: {name: [args]}."""
    calls = {name: [] for name in NAMES}

    def recorder(name):
        def rec(*a):
            calls[name].append(_clone(a))
            return getattr(PLAIN, name)(*a)
        return rec

    r = _rasterizer(case, PLAIN._replace(**{name: recorder(name) for name in NAMES}))
    r.render_frame()
    assert r.resolved_scheme() == "kernel" and r.resolved_layers() == LAYERS
    return calls


@pytest.fixture(scope="module")
def raster_calls():
    return {case: _calls(case) for case in CASES}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", NAMES)
def test_raster_kernels_are_bit_exact(lib, exact_sqrt, host_pow, raster_calls, name, case):
    """Every call of the frame (4 surfaces, 36 light rays, 4 shadings):
    the emulated kernel's outputs are the plain version's. The first layer
    holds misses (slot -1, shaded as triangle 0), the second and third hits
    behind the first surface (the fourth misses everywhere at this size);
    "dark_light" a light of strength 0, "tpo_atlas" the TPO atlas's
    seeded 4x2 texture beside theater's 1x1 one."""
    calls = raster_calls[case]
    assert [len(calls[n]) for n in NAMES] == [LAYERS, LAYERS * LIGHTS, LAYERS]
    launch = getattr(RK, f"_{name}_launch")
    plain = getattr(RK, f"{name}_plain")
    for args in calls[name]:
        got, ref = launch(lib, 0, *_clone(args)), plain(*_clone(args))
        got, ref = (got, ref) if isinstance(got, tuple) else ((got,), (ref,))
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a, b)
    shade = calls["raster_shade"]
    slots = [args[11] for args in shade]
    assert (slots[0] == -1).any() and (slots[0] >= 0).any()
    assert (slots[1] >= 0).any() and (slots[2] >= 0).any()
    lights = shade[0][6]
    assert (lights[:, 1, 0] == 0.0).any() == (case == "dark_light")
    tpo_num = shade[0][1][:, 17]
    assert (tpo_num == 1).any() == (case == "tpo_atlas")


def test_raster_kernels_render_the_plain_frame(lib, exact_sqrt, host_pow):
    """A whole frame through the rasterizer with the emulated shading
    kernels (the casts and FXAA plain) is the frame with the plain
    versions, value for value."""
    def emulated(name):
        launch = getattr(RK, f"_{name}_launch")
        return lambda *a: launch(lib, 0, *a)

    frames = [_rasterizer("theater", kernels).render_frame()
              for kernels in (PLAIN, PLAIN._replace(**{n: emulated(n) for n in NAMES}))]
    assert frames[0].max() > 0
    np.testing.assert_array_equal(frames[1], frames[0])


def test_raster_launches_reject_what_the_kernels_do_not_take(lib, raster_calls):
    args = raster_calls["theater"]["raster_shade"][0]
    with pytest.raises(TypeError):   # shadow flags as float
        RK._raster_shade_launch(lib, 0, *args[:12], args[12].float(), args[13])
    with pytest.raises(ValueError):  # a flag row short
        RK._raster_shade_launch(lib, 0, *args[:12], args[12][1:], args[13])
    origin, lights, _ = raster_calls["theater"]["raster_rays"][0]
    with pytest.raises(IndexError):
        RK._raster_rays_launch(lib, 0, origin, lights, LIGHTS)
    with pytest.raises(ValueError):  # rows, not SoA
        RK._raster_rays_launch(lib, 0, origin.T, lights, 0)
