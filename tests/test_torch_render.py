"""The port's slice against flexlight_tpu: render_mrt (the MRT contract)
and whole frames through PathTracer, at 24 px with <= 3 bounces.

The reference here is flexlight_tpu run op by op (jax.disable_jit, or
render_mrt called outside jit), which is the JAX package's arithmetic as
written. Under jit, XLA also rewrites float expressions (it folds
`x / W * 2` in the camera NDC into `x * (2 / W)`, and fuses the hash's
sin), so a jitted frame differs from the op-by-op one in the random
numbers of whole pixel rows (measured on cornell: 76% of pixels under the
counter RNG); the port follows the op-by-op arithmetic.

Tolerances, with their reasons:
- RNG-free channels (alpha, location_id, original_color, glass): 1e-5.
- color under rng="counter" (integer hash, bit-exact): 1e-5 on cornell,
  where no traversal tie decides a pixel.
- color under rng="hash": the sin amplifies a 1-ulp libm difference, so
  these tests put flexlight_tpu's own sin in the port (rng._sin) and then
  hold the same 1e-5.
- theater and example2 (9 and 64 jittered lights): a traversal tie or a
  reservoir choice on a knife edge moves a few pixels; the budget is the
  JAX package's own between its schemes (tests/test_examples.py:82-88):
  <= 5% of pixels over 1e-3.
- whole frames: the golden budget (<= 1% of values over 2e-3, max <= 0.5),
  except the denoised frame. Its tap sums (and the fast mode's tile means
  of the blur key) run in another order than the reference's, which flips
  isolated rgba8 steps that the later passes spread, and FXAA decides
  exact span ties either way (tests/test_fxaa_kernel.py): <= 5% of values
  over 2e-3, <= 0.5% over 1e-2, max <= 0.5.
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from flexlight_tpu import Config  # noqa: E402
from flexlight_tpu import FlexLight as JaxFlexLight  # noqa: E402
from flexlight_tpu.ops import buffers as jbuf  # noqa: E402
from flexlight_tpu.ops.pathtrace import render_mrt as jrender  # noqa: E402
import flexlight_tpu_torch as port  # noqa: E402
from flexlight_tpu_torch.ops import rng as trng  # noqa: E402
from flexlight_tpu_torch.ops.buffers import buffers_from_numpy  # noqa: E402
from flexlight_tpu_torch.ops.pathtrace import render_mrt  # noqa: E402
from flexlight_tpu_torch.scenes import stand_in_wood_texture, theater  # noqa: E402
from tests.scenes import cornell_config, cornell_scene  # noqa: E402

SIZE = 24
RNG_FREE = ("alpha", "location_id", "original_color", "glass")
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


@pytest.fixture
def reference_sin(monkeypatch):
    """flexlight_tpu's sin in the port's hash."""
    monkeypatch.setattr(trng, "_sin", lambda x: torch.from_numpy(np.array(
        jnp.sin(jnp.asarray(x.numpy())))))


def _scene(name):
    if name == "cornell":
        return cornell_scene()
    if name == "theater":
        e = theater(stand_in_wood_texture(0), device="cpu")
        return e.scene, e.camera
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))
    import importlib

    e = importlib.import_module(name).build_scene()
    e = e[0] if isinstance(e, tuple) else e
    return e.scene, e.camera


def _mrts(name, rng, scheme, max_reflections=3):
    scene, camera = _scene(name)
    jb = jbuf.build_scene_buffers(scene)
    tb = buffers_from_numpy(jax.tree.map(np.asarray, jb), "cpu")
    cfg = Config(temporal=False, filter=False, antialiasing=None,
                 max_reflections=max_reflections, rng=rng)
    pos, view = camera.position, camera.view_matrix(SIZE, SIZE)
    ref = jrender(jb, SIZE, SIZE, jnp.asarray(pos), jnp.asarray(view), cfg,
                  jnp.float32(0.0), scheme=scheme)
    got = render_mrt(tb, SIZE, SIZE, pos, view, cfg, 0.0)
    return ref, got


def _assert_channels(ref, got, names, atol):
    for ch in names:
        np.testing.assert_allclose(getattr(got, ch).numpy(), np.asarray(getattr(ref, ch)),
                                   atol=atol, rtol=0, err_msg=ch)


@pytest.mark.parametrize("scheme", ["kernel", "mxu"])
def test_render_mrt_cornell_counter_is_exact(scheme):
    """scheme="kernel" runs the dense Pallas kernel in interpret mode."""
    ref, got = _mrts("cornell", "counter", scheme)
    _assert_channels(ref, got, ref._fields, 1e-5)
    assert got.alpha.numpy().mean() > 0.5


@pytest.mark.parametrize("scheme", ["kernel", "mxu"])
def test_render_mrt_cornell_hash_is_exact_with_reference_sin(reference_sin, scheme):
    ref, got = _mrts("cornell", "hash", scheme)
    _assert_channels(ref, got, ref._fields, 1e-5)


@pytest.mark.parametrize("name,rng", [("theater", "counter"), ("theater", "hash"),
                                      ("example2", "counter")])
def test_render_mrt_many_lights(reference_sin, name, rng):
    """theater (textured, 9 lights) and example2 (64 lights: the reference
    scans the light loop there) against the kernel scheme."""
    ref, got = _mrts(name, rng, "kernel", max_reflections=2)
    _assert_channels(ref, got, RNG_FREE, 1e-5)
    d = np.abs(got.color.numpy() - np.asarray(ref.color)).max(axis=-1)
    assert (d > 1e-3).mean() <= 0.05, (d > 1e-3).mean()


def _frame_config(mode, rng="hash"):
    if mode == "direct":
        cfg = cornell_config(max_reflections=3)
    elif mode == "temporal":
        cfg = cornell_config(temporal=True, temporal_samples=2, max_reflections=3)
    else:
        cfg = cornell_config(filter=True, temporal=True, temporal_samples=2,
                             max_reflections=3, antialiasing="fxaa", filter_mode=mode)
    return cfg.replace(rng=rng)


def _frames(cfg, use_port, n=2):
    """Frames of cornell on either package's engine, the scene built with
    that package's classes."""
    import flexlight_tpu as jpkg
    from tests.test_torch_scene_copy import build

    engine = port.FlexLight((SIZE, SIZE), device="cpu") if use_port else JaxFlexLight((SIZE, SIZE))
    engine.scene, engine.camera = build("cornell", port if use_port else jpkg)
    engine.config = port.Config(**vars(cfg)) if use_port else cfg
    engine.renderer = "pathtracer"
    if use_port:
        return [engine.renderer.render_frame() for _ in range(n)]
    engine.renderer.scheme = "mxu"
    with jax.disable_jit():
        return [engine.renderer.render_frame() for _ in range(n)]


def _golden_budget(a, b):
    d = np.abs(a - b)
    assert (d > 2e-3).mean() <= 0.01, (d > 2e-3).mean()
    assert d.max() <= 0.5


@pytest.mark.parametrize("mode", ["direct", "temporal"])
def test_frames_match_reference_pathtracer(reference_sin, mode):
    cfg = _frame_config(mode)
    for a, b in zip(_frames(cfg, True), _frames(cfg, False)):
        assert a.shape == (SIZE, SIZE, 3) and np.isfinite(a).all()
        _golden_budget(a, b)


@pytest.mark.parametrize("mode", ["compat", "fast"])
def test_denoised_frames_match_reference_pathtracer(mode):
    """temporal + 3+3+final filter + FXAA, counter RNG."""
    cfg = _frame_config(mode, rng="counter")
    for a, b in zip(_frames(cfg, True), _frames(cfg, False)):
        d = np.abs(a - b)
        assert (d > 2e-3).mean() <= 0.05, (d > 2e-3).mean()
        assert (d > 1e-2).mean() <= 0.005, (d > 1e-2).mean()
        assert d.max() <= 0.5


@pytest.mark.parametrize("mode", ["direct", "temporal", "filter"])
def test_frames_against_goldens(mode):
    """tests/goldens/cornell_*_24.npz were rendered by the jitted JAX
    package (scheme="scan", hash RNG): the jit's float rewrites give its
    hash other random numbers than the op-by-op arithmetic, and
    flexlight_tpu's own op-by-op frame misses the pixel budget against
    these files as far as the port does (measured: 31%, 41%, 85% of
    values over 2e-3; mean abs 0.054, 0.063, 0.023, for both). What the
    goldens fix beyond the noise is the image: the port's frame must keep
    its mean within 0.015 and its mean abs difference within 0.08."""
    golden = np.load(os.path.join(GOLDEN_DIR, f"cornell_{mode}_24.npz"))["img"]
    cfg = _frame_config("compat" if mode == "filter" else mode)
    img = _frames(cfg, True, 1 if mode == "direct" else 2)[-1]
    assert img.shape == golden.shape and np.isfinite(img).all()
    assert abs(float(img.mean()) - float(golden.mean())) <= 0.015
    assert float(np.abs(img - golden).mean()) <= 0.08


def test_reservoir_sample_matches():
    """Reservoir NEE over theater's 9 jittered lights with one shadow ray,
    counter RNG, a fixed shadow pattern standing in for the any-hit cast:
    the same float operations, so 1e-5."""
    from flexlight_tpu.ops import pathtrace as jpt
    from flexlight_tpu_torch.ops import pathtrace as tpt

    scene, _ = _scene("theater")
    jb = jbuf.build_scene_buffers(scene)
    tb = buffers_from_numpy(jax.tree.map(np.asarray, jb), "cpu")
    rng = np.random.default_rng(8)
    n = 1024

    def unit():
        v = rng.normal(size=(3, n)).astype(np.float32)
        return v / np.linalg.norm(v, axis=0)

    arrays = dict(albedo3=rng.uniform(0, 1, (3, n)), rough=rng.uniform(0, 1, n),
                  metal=rng.uniform(0, 1, n), emis=rng.uniform(0, 0.2, n),
                  origin3=rng.uniform(-20, 20, (3, n)), unit_dir3=unit(),
                  random_vec4=rng.uniform(-1, 1, (4, n)), n_rough3=unit(),
                  n_smooth3=unit(), geometry_offset=rng.uniform(0, 0.01, n))
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    shadow = (np.arange(n) % 3 == 0)

    def conv(f):
        return {k: (tuple(f(c) for c in v) if v.ndim == 2 else f(v)) for k, v in arrays.items()}

    ref = jpt.reservoir_sample(jb, **conv(jnp.asarray), random_seed=jnp.float32(1.0),
                               shadow_soa=lambda o, d, m, alive=None, hint=None:
                               jnp.asarray(shadow), rng_mode="counter")
    got = tpt.reservoir_sample(tb, **conv(torch.from_numpy), random_seed=1.0,
                               shadow_soa=lambda o, d, m, alive=None:
                               torch.from_numpy(shadow), rng_mode="counter")
    for a, b in zip((*ref[0], ref[1]), (*got[0], got[1])):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-6)
