"""flexlight_tpu_torch's device contract and math leaves against
flexlight_tpu on the same inputs: scene buffers field for field, the
theater scene against examples/theater.py, the per-frame transform
bake, the BRDF, both RNG modes and the atlas fetch."""

import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from flexlight_tpu.ops import brdf as jbrdf  # noqa: E402
from flexlight_tpu.ops import buffers as jbuf  # noqa: E402
from flexlight_tpu.ops import rng as jrng  # noqa: E402
from flexlight_tpu.ops.geometry import world_geometry as jworld  # noqa: E402
from flexlight_tpu.scene.scene import Texture as JaxTexture  # noqa: E402
from flexlight_tpu.scene.transform import reset_global_registry  # noqa: E402
from flexlight_tpu_torch import Texture  # noqa: E402
from flexlight_tpu_torch import reset_global_registry as reset_port_registry  # noqa: E402
from flexlight_tpu_torch.ops import brdf as tbrdf  # noqa: E402
from flexlight_tpu_torch.ops import buffers as tbuf  # noqa: E402
from flexlight_tpu_torch.ops import rng as trng  # noqa: E402
from flexlight_tpu_torch.ops.geometry import world_geometry as tworld  # noqa: E402
from flexlight_tpu_torch.scenes import stand_in_wood_data, stand_in_wood_texture, theater  # noqa: E402
from tests.test_torch_scene_copy import both_buffers  # noqa: E402

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


def _buffers(name):
    """(port SceneBuffers on the CPU, flexlight_tpu SceneBuffers) of the
    scene `name`, each built with its own package's classes (each package
    keeps its own transform registry)."""
    jb, tb, _ = both_buffers(name)
    return tb, jb


def assert_buffers_equal(tb, jb):
    """Every field (and every atlas-table field) equal in dtype, shape and
    value: the buffers are data, so nothing less than exact will do."""
    for name in tbuf.SceneBuffers._fields:
        a, b = getattr(tb, name), getattr(jb, name)
        pairs = zip(a, b) if name.endswith("_tab") else [(a, b)]
        for x, y in pairs:
            y = np.asarray(y)
            assert x.numpy().dtype == y.dtype, name
            assert tuple(x.shape) == y.shape, name
            np.testing.assert_array_equal(x.numpy(), y, err_msg=name)


@pytest.mark.parametrize("name", ["cornell", "example2", "emissive", "wave", "theater"])
def test_buffers_match_reference_field_for_field(name):
    assert_buffers_equal(*_buffers(name))


def test_buffers_from_numpy_carries_the_reference_buffers():
    _, jb = _buffers("theater")
    tb = tbuf.buffers_from_numpy(jax.tree.map(np.asarray, jb), "cpu")
    assert_buffers_equal(tb, jb)
    assert tb.albedo_tab.texels.dtype == torch.uint8  # stand-in wood stays exact bytes


def test_theater_scene_pins_to_the_example(monkeypatch):
    """scenes.theater is examples/theater.py's build_scene with the floor
    texture passed in: with the example's texture loader returning the
    stand-in, both build identical buffers."""
    sys.path.insert(0, EXAMPLES)
    import common
    import theater as example_theater

    wood = stand_in_wood_data(3)
    jwood = JaxTexture(wood)
    monkeypatch.setattr(common, "load_texture", lambda path: jwood)
    monkeypatch.setattr(example_theater, "load_texture", lambda path: jwood)
    reset_global_registry()
    ref = jbuf.build_scene_buffers(example_theater.build_scene().scene)
    reset_port_registry()
    got = tbuf.build_scene_buffers(theater(Texture(wood), device="cpu").scene, "cpu")
    assert_buffers_equal(got, ref)


def test_stand_in_texture_is_seeded_and_byte_exact():
    a, b, c = stand_in_wood_texture(1), stand_in_wood_texture(1), stand_in_wood_texture(2)
    assert a.data.shape == (512, 512, 3)
    np.testing.assert_array_equal(a.data, b.data)
    assert not np.array_equal(a.data, c.data)
    q = np.round(a.data * 255.0)
    np.testing.assert_array_equal(q.astype(np.float32) * np.float32(1 / 255), a.data)


@pytest.mark.parametrize("name", ["cornell", "wave"])
def test_world_geometry_matches(name):
    """The transform bake: 3-term products written out in XLA's order,
    so equal to float32 rounding (1e-5 relative)."""
    tb, jb = _buffers(name)
    ref = np.asarray(jworld(jb))
    np.testing.assert_allclose(tworld(tb).numpy(), ref, rtol=1e-5, atol=1e-6)


def _rand(rng, n, lo=-1.0, hi=1.0):
    return rng.uniform(lo, hi, n).astype(np.float32)


def test_rng_counter_is_bit_exact():
    """The counter hash is integer arithmetic on float bits: bit for bit."""
    rng = np.random.default_rng(0)
    n0, n1 = _rand(rng, 4096), _rand(rng, 4096)
    ref = jrng.noise4(jnp.asarray(n0), jnp.asarray(n1), 1.5, jnp.float32(2.0), mode="counter")
    got = trng.noise4(torch.from_numpy(n0), torch.from_numpy(n1), 1.5, 2.0, mode="counter")
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_rng_hash_matches_with_the_reference_sin(monkeypatch):
    """The sin hash amplifies a 1-ulp libm difference into a different
    number (docs/PARITY.md), so the arithmetic around it is held with the
    reference's own sin in place: then bit for bit. Without it, the two
    sins agree on most arguments and the outputs stay in [-1, 1)."""
    rng = np.random.default_rng(1)
    n0, n1 = _rand(rng, 4096), _rand(rng, 4096)
    ref = jrng.noise4(jnp.asarray(n0), jnp.asarray(n1), 1.0, jnp.float32(3.0), mode="hash")
    own = trng.noise4(torch.from_numpy(n0), torch.from_numpy(n1), 1.0, 3.0, mode="hash")
    for a, b in zip(ref, own):
        b = b.numpy()
        assert (b >= -1).all() and (b < 1).all()
        assert (np.abs(np.asarray(a) - b) < 1e-2).mean() > 0.8
    monkeypatch.setattr(trng, "_sin", lambda x: torch.from_numpy(np.array(
        jnp.sin(jnp.asarray(x.numpy())))))
    got = trng.noise4(torch.from_numpy(n0), torch.from_numpy(n1), 1.0, 3.0, mode="hash")
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_forward_trace_matches():
    """Cook-Torrance of one light, SoA: float32 rounding of the same
    expression order (rtol 1e-5)."""
    rng = np.random.default_rng(2)
    n = 2048

    def unit():
        v = rng.normal(size=(3, n)).astype(np.float32)
        return v / np.linalg.norm(v, axis=0)

    albedo = rng.uniform(0, 1, (3, n)).astype(np.float32)
    rough, metal, emis = (_rand(rng, n, 0, 1) for _ in range(3))
    light_dir = rng.normal(size=(3, n)).astype(np.float32) * 5
    nrm, view = unit(), unit()
    ref = jbrdf.forward_trace_soa(tuple(jnp.asarray(c) for c in albedo), jnp.asarray(rough),
                                  jnp.asarray(metal), jnp.asarray(emis),
                                  tuple(jnp.asarray(c) for c in light_dir), 50.0,
                                  tuple(jnp.asarray(c) for c in nrm),
                                  tuple(jnp.asarray(c) for c in view))
    got = tbrdf.forward_trace_soa(tuple(torch.from_numpy(c) for c in albedo),
                                  torch.from_numpy(rough), torch.from_numpy(metal),
                                  torch.from_numpy(emis),
                                  tuple(torch.from_numpy(c) for c in light_dir), 50.0,
                                  tuple(torch.from_numpy(c) for c in nrm),
                                  tuple(torch.from_numpy(c) for c in view))
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-7)


def test_atlas_fetch_matches_including_u8_texels():
    """The compact-table fetch returns the reference's values exactly (u8
    texels reconstruct as k * f32(1/255)); misses take the default."""
    tb, jb = _buffers("theater")
    rng = np.random.default_rng(4)
    n = 4096
    u, v = _rand(rng, n, -0.5, 1.5), _rand(rng, n, -0.5, 1.5)
    tex = rng.integers(-1, 3, n).astype(np.float32)
    default = tuple(_rand(rng, n, 0, 1) for _ in range(3))
    for jt, tt in ((jb.albedo_tab, tb.albedo_tab), (jb.pbr_tab, tb.pbr_tab),
                   (jb.tpo_tab, tb.tpo_tab)):
        ref = jbuf.fetch_tex_val_table(jt, jnp.asarray(u), jnp.asarray(v), jnp.asarray(tex),
                                       tuple(jnp.asarray(d) for d in default))
        got = tbuf.fetch_tex_val_table(tt, torch.from_numpy(u), torch.from_numpy(v),
                                       torch.from_numpy(tex),
                                       tuple(torch.from_numpy(d) for d in default))
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_forward_trace_rows_match():
    """The [..., 3]-row form of the BRDF (rtol 1e-5, as above)."""
    rng = np.random.default_rng(3)
    n = 512
    albedo, rme = rng.uniform(0, 1, (n, 3)), rng.uniform(0, 1, (n, 3))
    light_dir = rng.normal(size=(n, 3)) * 5
    nrm, view = (v / np.linalg.norm(v, axis=-1, keepdims=True)
                 for v in (rng.normal(size=(n, 3)), rng.normal(size=(n, 3))))
    args = [x.astype(np.float32) for x in (albedo, rme, light_dir)]
    rest = [x.astype(np.float32) for x in (nrm, view)]
    ref = jbrdf.forward_trace(*(jnp.asarray(a) for a in args), 30.0,
                              *(jnp.asarray(a) for a in rest))
    got = tbrdf.forward_trace(*(torch.from_numpy(a) for a in args), 30.0,
                              *(torch.from_numpy(a) for a in rest))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-7)


def test_scalar_moeller_trumbore_matches():
    """The scalar MT tests of ops/intersect.py on random triangles and
    rays: same accept windows, float32 rounding of the same expressions."""
    from flexlight_tpu.ops import intersect as jint
    from flexlight_tpu_torch.ops import intersect as tint

    rng = np.random.default_rng(12)
    n = 4096
    v0, v1, v2, o = (rng.uniform(-1, 1, (n, 3)).astype(np.float32) for _ in range(4))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ml = rng.uniform(0, 3, n).astype(np.float32)
    j = [jnp.asarray(x) for x in (v0, v1, v2, o, d, ml)]
    t = [torch.from_numpy(x) for x in (v0, v1, v2, o, d, ml)]
    ref = np.asarray(jint.moeller_trumbore(*j))
    got = tint.moeller_trumbore(*t).numpy()
    assert (ref[:, 0] > 0).any()
    np.testing.assert_array_equal(got[:, 0] > 0, ref[:, 0] > 0)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tint.moeller_trumbore_cull(*t).numpy(),
                                  np.asarray(jint.moeller_trumbore_cull(*j)))


def test_brdf_helpers_match():
    rng = np.random.default_rng(13)
    v = rng.normal(size=(256, 3)).astype(np.float32)
    np.testing.assert_allclose(tbrdf.normalize(torch.from_numpy(v)).numpy(),
                               np.asarray(jbrdf.normalize(jnp.asarray(v))), rtol=1e-6, atol=1e-7)
    f0, theta = rng.uniform(0, 1, (256, 3)).astype(np.float32), _rand(rng, 256, 0, 1)[:, None]
    np.testing.assert_allclose(
        tbrdf.fresnel(torch.from_numpy(f0), torch.from_numpy(theta)).numpy(),
        np.asarray(jbrdf.fresnel(jnp.asarray(f0), jnp.asarray(theta))), rtol=1e-6, atol=1e-7)
