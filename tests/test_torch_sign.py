"""The port's sign (ops/vec3.py sign, csrc/trace.cuh fl_sign) against
flexlight_tpu's jnp.sign, and what the shading does with it.

jnp.sign keeps the sign of a zero (-0 -> -0), propagates NaN, and on
XLA's CPU flushes a denormal input to its signed zero; torch.sign gives +0
for -0 and NaN and +-1 for a denormal. The shading flips the normal by
-sign(dot(ray_dir, normal)) (glsl:531), so on a triangle slot with zero
normals the dot is a signed zero and the two signs pack different
render-id nibbles. Exact comparisons throughout: the values are the same
floats or they are not.
"""

import shutil

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import flexlight_tpu as jpkg  # noqa: E402
from flexlight_tpu.ops import buffers as jbuf  # noqa: E402
from flexlight_tpu.ops.fused import render_mrt_fused as jax_fused  # noqa: E402
import flexlight_tpu_torch as port  # noqa: E402
from flexlight_tpu_torch.kernels import PLAIN  # noqa: E402
from flexlight_tpu_torch.ops import vec3 as v3  # noqa: E402
from flexlight_tpu_torch.ops.buffers import buffers_from_numpy  # noqa: E402
from flexlight_tpu_torch.ops.pathtrace import render_mrt  # noqa: E402
from tests.test_torch_scene_copy import build  # noqa: E402

SPECIAL = np.array([0.0, -0.0, np.nan, -np.nan, 1e-40, -1e-40, 1e-45, -1e-45,
                    np.float32(1.1754944e-38), -np.float32(1.1754944e-38), 1.17549e-38,
                    -1.17549e-38, 2.0, -3.0, 1e-30, -1e-30, np.inf, -np.inf], dtype=np.float32)


def _bits(a) -> np.ndarray:
    """float32 bits, every NaN as one pattern."""
    a = np.asarray(a, dtype=np.float32)
    return np.where(np.isnan(a), np.uint32(0x7FC00000), a.view(np.uint32))


def test_sign_is_jnp_sign():
    """+-0, NaN, denormals of both signs, FLT_MIN and ordinary values."""
    vals = np.concatenate([SPECIAL, np.random.default_rng(0).normal(0, 10, 1000).astype(
        np.float32)])
    got = v3.sign(torch.from_numpy(vals)).numpy()
    ref = np.asarray(jnp.sign(jnp.asarray(vals)))
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    # torch.sign alone differs on exactly the cases this function exists for
    differ = _bits(torch.sign(torch.from_numpy(vals)).numpy()) != _bits(ref)
    cases = ((vals == 0) & np.signbit(vals)) | np.isnan(vals) | (
        (vals != 0) & (np.abs(vals) < v3.FLT_MIN))
    assert cases.sum() == 9
    np.testing.assert_array_equal(differ, cases)


def test_clamp_min0_is_jnp_maximum():
    """next_ray_dir's max(sign_dir, 0): the signs' values and more."""
    vals = SPECIAL[~((SPECIAL != 0) & (np.abs(SPECIAL) < v3.FLT_MIN))]  # XLA flushes those
    got = v3.clamp_min0(torch.from_numpy(vals)).numpy()
    ref = np.asarray(jnp.maximum(jnp.asarray(vals), 0.0))
    np.testing.assert_array_equal(_bits(got), _bits(ref))


def test_filter_signs_agree_on_their_inputs():
    """The audit of post/filters.py: its torch.sign calls (vote_repair's
    1 - sign(max_vote), the first pass's sign(color.w)) take byte-decoded
    planes (k * f32(1/255), +0 for k = 0) and vote counts (0..37), where
    torch.sign is jnp.sign, so they stay as they are."""
    levels = np.arange(256, dtype=np.float32) * np.float32(1.0 / 255.0)
    votes = np.arange(38, dtype=np.float32)
    for vals in (levels, votes):
        np.testing.assert_array_equal(_bits(torch.sign(torch.from_numpy(vals)).numpy()),
                                      _bits(jnp.sign(jnp.asarray(vals))))


def _zero_normal_wave():
    """wave's buffers from flexlight_tpu with the normals of its plane's
    two triangle slots set to zero, the same buffers for the port, and the
    camera. wave's camera looks down at the plane, so primary rays meet it
    with all direction components negative: dot(ray_dir, 0) is -0."""
    jscene, camera = build("wave", jpkg)
    jb = jbuf.build_scene_buffers(jscene)
    geometry = np.asarray(jb.geometry)
    plane = np.nonzero(np.all(np.abs(geometry[:, [0, 3, 6]]) == 100.0, axis=1)
                       & np.all(geometry[:, [1, 4, 7]] == -1.0, axis=1))[0]
    assert len(plane) == 2
    attributes = np.asarray(jb.attributes).copy()
    assert np.abs(attributes[plane, 0:9]).sum() > 0
    attributes[plane, 0:9] = 0.0
    jb = jb._replace(attributes=jnp.asarray(attributes))
    return jb, buffers_from_numpy(jax.tree.map(np.asarray, jb), "cpu"), camera


def test_zero_normal_slot_renders_the_reference_render_id(monkeypatch):
    """A plane with zero normals: the port's MRT equals flexlight_tpu's,
    render id included (both fused schemes, op by op). With torch.sign in
    its place the render id differs, as it did before the repair."""
    jb, tb, camera = _zero_normal_wave()
    size = 16
    cfg = port.Config(temporal=False, filter=False, antialiasing=None, rng="counter",
                      max_reflections=2)
    pos, view = camera.position, camera.view_matrix(size, size)
    ref = jax_fused(jb, size, size, jnp.asarray(pos), jnp.asarray(view),
                    jpkg.Config(**vars(cfg)), jnp.float32(0.0), pallas=False)
    got = render_mrt(tb, size, size, pos, view, cfg, 0.0, scheme="fused", kernels=PLAIN)
    assert got.alpha.numpy().mean() == 1.0
    for ch in ref._fields:
        np.testing.assert_allclose(getattr(got, ch).numpy(), np.asarray(getattr(ref, ch)),
                                   atol=1e-5, rtol=0, err_msg=ch)
    monkeypatch.setattr(v3, "sign", torch.sign)
    old = render_mrt(tb, size, size, pos, view, cfg, 0.0, scheme="fused", kernels=PLAIN)
    assert np.abs(old.render_id.numpy() - np.asarray(ref.render_id)).max() > 0.1


@pytest.mark.skipif(shutil.which("g++") is None and shutil.which("c++") is None,
                    reason="no host C++ compiler for the emulated kernel build")
def test_emulated_kernels_take_the_same_sign(tmp_path, monkeypatch):
    """fl_sign on the zero-normal plane: the host build of the fused_frame
    kernel (whose shading, fl_bounce_shade and fl_bounce_apply, POST and the
    shading kernels share) is identical to its plain version there."""
    from flexlight_tpu_torch import _native
    from flexlight_tpu_torch.ops import fused as F
    from flexlight_tpu_torch.ops import fused_kernel as FK
    from flexlight_tpu_torch.ops.pathtrace import sample_cos

    monkeypatch.setattr(v3, "sqrt", lambda x: torch.sqrt(x.double()).to(torch.float32))
    lib = _native.build_library(tmp_path, emulate=True)
    _, tb, camera = _zero_normal_wave()
    cfg = port.Config(temporal=False, filter=False, antialiasing=None, rng="counter",
                      max_reflections=3)
    cam, dirs, ndc, w4, ids, mat = F.frame_inputs(tb, 12, 12, camera.position,
                                                   camera.view_matrix(12, 12))
    args = (dirs, ndc, w4, ids, mat, tb.lights, tb.ambient, tb.albedo_tab, tb.pbr_tab,
            tb.tpo_tab, cam, torch.tensor(0.0), torch.tensor([sample_cos(0)]), cfg)
    got = FK._fused_frame_launch(lib, 0, *args)
    ref = F.fused_frame_plain(*args)
    assert torch.equal(got, ref)
    monkeypatch.setattr(v3, "sign", torch.sign)
    assert not torch.equal(F.fused_frame_plain(*args), ref)
