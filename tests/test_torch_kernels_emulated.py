"""The CUDA kernels of flexlight_tpu_torch/csrc, compiled for the host
(-DFL_EMULATE: every thread runs in turn as a block of one) and launched
through the same Python launch code as on the card, against their plain
PyTorch versions on the slice's kinds of input.

The kernels are written to take the plain versions' float operations in
the same order (and are built without FMA contraction), so the expected
agreement is bit for bit. The one exception is the final pass's gamma
curve: the host's powf and torch's pow may differ by an ulp (1e-6).
On the card, chip_smoke.py holds the same comparison at 1080p."""

import shutil

import numpy as np
import pytest
import torch

from flexlight_tpu_torch import _native
from flexlight_tpu_torch.models.pathtracer import PLAIN, KernelSet, PathTracer
from flexlight_tpu_torch.ops import intersect_kernel as IK
from flexlight_tpu_torch.ops.intersect import BIAS, POW32
from flexlight_tpu_torch.post import filter_kernel as FK
from flexlight_tpu_torch.post import fxaa_kernel as XK
from flexlight_tpu_torch.scenes import stand_in_wood_texture, theater

pytestmark = pytest.mark.skipif(shutil.which("g++") is None and shutil.which("c++") is None,
                                reason="no host C++ compiler for the emulated kernel build")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return _native.build_library(tmp_path_factory.mktemp("kernels"), emulate=True)


@pytest.fixture(scope="module")
def frame_inputs():
    """The first inputs each kernel gets in one real theater frame (full
    pipeline, 48x32, 3 bounces), recorded from the plain run."""
    from flexlight_tpu import Config

    captured = {}

    def recorder(name, fn):
        def rec(*a):
            captured.setdefault(name, a)
            return fn(*a)
        return rec

    kernels = KernelSet(*(recorder(n, f) for n, f in zip(KernelSet._fields, PLAIN)))
    e = theater(stand_in_wood_texture(0), device="cpu")
    cfg = Config(temporal=True, temporal_samples=4, filter=True, antialiasing="fxaa",
                 samples_per_ray=1, max_reflections=3)
    PathTracer(48, 32, e.scene, e.camera, cfg, "cpu", kernels=kernels).render_frame()
    return captured


def _random_wavefront(n, seed):
    rng = np.random.default_rng(seed)
    o = tuple(torch.from_numpy(rng.uniform(-40, 40, n).astype(np.float32)) for _ in range(3))
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    d[:, ::17] = 0.0  # zero directions are cast as +z
    d = tuple(torch.from_numpy(np.ascontiguousarray(c)) for c in d)
    ml = torch.from_numpy(np.where(rng.uniform(size=n) < 0.1, 0.0,
                                   rng.uniform(0, 60, n)).astype(np.float32))
    return o, d, ml


def _same(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_closest_hit_kernel_is_bit_exact(lib, frame_inputs):
    w4, ids, o3, d3, ml, edge = frame_inputs["closest_hit"]
    _same(IK._closest_hit_launch(lib, 0, w4, ids, o3, d3, ml, edge),
          IK.closest_hit_plain(w4, ids, o3, d3, ml, edge))
    o, d, rml = _random_wavefront(3000, 1)
    rml = torch.where(rml > 0, POW32, 0.0)
    got = IK._closest_hit_launch(lib, 0, w4, ids, o, d, rml, BIAS)
    _same(got, IK.closest_hit_plain(w4, ids, o, d, rml, BIAS))
    assert (got[3] >= 0).any()


def test_any_hit_kernel_is_bit_exact(lib, frame_inputs):
    w4, o3, d3, ml = frame_inputs["any_hit"]
    _same([IK._any_hit_launch(lib, 0, w4, o3, d3, ml)], [IK.any_hit_plain(w4, o3, d3, ml)])
    o, d, rml = _random_wavefront(3000, 2)
    got = IK._any_hit_launch(lib, 0, w4, o, d, rml)
    _same([got], [IK.any_hit_plain(w4, o, d, rml)])
    assert got.any() and not got.all()


def _random_packed5(seed, h=24, w=40):
    rng = np.random.default_rng(seed)
    q = lambda x: np.round(np.clip(x, 0, 1) * 255).astype(np.float32) * np.float32(1 / 255)
    ids = q(rng.uniform(0, 1, (5, 4)))[rng.integers(0, 5, (h, w))]
    oid = q(rng.uniform(0, 1, (3, 4)))[rng.integers(0, 3, (h, w))]
    color = q(rng.uniform(0, 1, (h, w, 4)))
    ip = q(np.where(rng.uniform(size=(h, w, 4)) < 0.3, rng.uniform(0, 0.3, (h, w, 4)), 0))
    ocw = q(np.where(rng.uniform(size=(h, w)) < 0.5, rng.uniform(0, 1, (h, w)), 0))
    ocolor = np.concatenate([q(rng.uniform(0, 1, (h, w, 3))), ocw[..., None]], -1)
    return torch.stack([FK.pack_rgba8(torch.from_numpy(x)) for x in (ids, oid, color, ip, ocolor)])


@pytest.mark.parametrize("which", ["first", "second"])
def test_disc_passes_are_bit_exact(lib, frame_inputs, which):
    launch = getattr(FK, f"_{which}_blur_launch")
    plain = getattr(FK, f"{which}_blur_plain")
    for p5 in (frame_inputs[f"{which}_blur"][0], _random_packed5(3)):
        _same(launch(lib, 0, p5), plain(p5))


@pytest.mark.parametrize("hdr", [True, False])
def test_final_pass_matches(lib, frame_inputs, hdr):
    for p5 in (frame_inputs["final_blur"][0], _random_packed5(4)):
        got = FK._final_blur_launch(lib, 0, p5, hdr)
        ref = FK.final_blur_plain(p5, hdr)
        assert got.shape == ref.shape == (p5.shape[1], p5.shape[2], 3)
        torch.testing.assert_close(got, ref, atol=1e-6, rtol=0)


def test_fxaa_kernel_is_bit_exact(lib, frame_inputs):
    rng = np.random.default_rng(6)
    blocky = np.kron(rng.uniform(0, 1, (4, 5, 4)), np.ones((8, 8, 1))).astype(np.float32)
    blocky[..., 3] = (blocky[..., 3] > 0.3).astype(np.float32)
    for img in (frame_inputs["fxaa"][0], torch.from_numpy(blocky)):
        _same([XK._fxaa_launch(lib, 0, img)], [XK.fxaa_cuda.plain(img)])


def test_launch_checks_reject_what_the_kernel_does_not_take(lib):
    p5 = _random_packed5(5)
    with pytest.raises(TypeError):
        FK._first_blur_launch(lib, 0, p5.to(torch.int64))
    with pytest.raises(ValueError):
        FK._second_blur_launch(lib, 0, p5[:4])
    with pytest.raises(ValueError):
        XK._fxaa_launch(lib, 0, torch.zeros(8, 8, 4).transpose(0, 1))
