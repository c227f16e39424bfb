"""scheme="fused" of the port (ops.fused: the whole-frame kernel's plain
version, fused_frame_plain, as the CPU runs it) against flexlight_tpu's
render_mrt_fused(pallas=False), at 16 px with <= 3 bounces; its identity
with the port's scheme="fused_split"; eligibility, refusals and the auto
rule.

Each side renders the scene built with its own package's classes; both
flatten to identical buffers first. The reference is flexlight_tpu run op
by op: pallas=False traces the whole-frame kernel's body as plain XLA ops
(tests/test_fused.py), which equals its scheme="mxu".

Tolerances, with their reasons (as in tests/test_torch_fused.py):
- wave and cornell at 1 spp, rng="counter": every MRT channel to 1e-5.
  wave's plane takes its roughness from the 2x2048 PBR atlas, so the
  atlas fetch (a one-hot contraction in the JAX kernel, an indexed read
  in the port) is held here too.
- rng="hash": the sin amplifies a 1-ulp libm difference, so the test puts
  flexlight_tpu's sin in the port (`reference_sin`) and holds 1e-5.
- example2 (63 lights) and the second sample: flexlight_tpu's kernel
  traverses with one matrix product per cast (ops/fused.py:126-134),
  which sums the bilinear terms in XLA's dot order; rays in the float32
  tie set (tests/test_torch_intersect.py:fp_tie_rays) may then hit
  otherwise, and a reservoir choice on a knife edge may flip. RNG-free
  channels, render_id and original_id_w to 1e-5; color within the JAX
  package's own budget between its schemes (tests/test_examples.py:82-88):
  <= 5% of pixels over 1e-3 (cornell at 16 px, spp 2: one pixel, 0.024).
- the port's fused against its own fused_split: identical. The kernel's
  plain version is the fused_split frame with the plain PRE and POST.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import flexlight_tpu as jpkg  # noqa: E402
from flexlight_tpu.ops.fused import fused_eligible as jax_fused_eligible  # noqa: E402
from flexlight_tpu.ops.fused import render_mrt_fused as jax_fused  # noqa: E402
import flexlight_tpu_torch as port  # noqa: E402
from flexlight_tpu_torch.kernels import PLAIN  # noqa: E402
from flexlight_tpu_torch.models.pathtracer import PathTracer  # noqa: E402
from flexlight_tpu_torch.ops import fused as F  # noqa: E402
from flexlight_tpu_torch.ops import rng as trng  # noqa: E402
from flexlight_tpu_torch.ops.buffers import build_scene_buffers  # noqa: E402
from flexlight_tpu_torch.ops.pathtrace import render_mrt  # noqa: E402
from tests.test_torch_scene_copy import assert_same_buffers, both_buffers, build  # noqa: E402

SIZE = 16
RNG_FREE = ("alpha", "location_id", "original_color", "glass")


@pytest.fixture
def reference_sin(monkeypatch):
    """flexlight_tpu's sin in the port's hash."""
    monkeypatch.setattr(trng, "_sin", lambda x: torch.from_numpy(np.array(
        jnp.sin(jnp.asarray(x.numpy())))))


def _config(rng, max_reflections=3, spp=1):
    return port.Config(temporal=False, filter=False, antialiasing=None, rng=rng,
                       max_reflections=max_reflections, samples_per_ray=spp)


def _mrts(name, rng, spp):
    jb, tb, camera = both_buffers(name)
    assert_same_buffers(jb, tb)
    cfg = _config(rng, spp=spp)
    pos, view = camera.position, camera.view_matrix(SIZE, SIZE)
    ref = jax_fused(jb, SIZE, SIZE, jnp.asarray(pos), jnp.asarray(view),
                    jpkg.Config(**vars(cfg)), jnp.float32(0.0), pallas=False)
    got = render_mrt(tb, SIZE, SIZE, pos, view, cfg, 0.0, scheme="fused", kernels=PLAIN)
    return ref, got, tb


def _assert_channels(ref, got, names, atol=1e-5):
    for ch in names:
        np.testing.assert_allclose(getattr(got, ch).numpy(), np.asarray(getattr(ref, ch)),
                                   atol=atol, rtol=0, err_msg=ch)


@pytest.mark.parametrize("name,rng", [("wave", "counter"), ("cornell", "counter"),
                                      ("wave", "hash")])
def test_fused_frame_matches_flexlight_tpu(reference_sin, name, rng):
    ref, got, tb = _mrts(name, rng, 1)
    _assert_channels(ref, got, ref._fields)
    assert got.alpha.numpy().mean() > 0.5 and got.color.numpy().max() > 0


@pytest.mark.parametrize("name,spp", [("example2", 1), ("wave", 2)])
def test_fused_frame_many_lights_and_samples(name, spp):
    """example2: 63 lights, above the 16 below which flexlight_tpu unrolls
    its reservoir loop; spp 2: the second sample restarts from the carried
    primary hit and channels, and the samples are summed."""
    ref, got, tb = _mrts(name, "counter", spp)
    assert tb.lights.shape[0] == (63 if name == "example2" else 1)
    _assert_channels(ref, got, RNG_FREE + ("render_id", "original_id_w"))
    d = np.abs(got.color.numpy() - np.asarray(ref.color)).max(axis=-1)
    assert (d > 1e-3).mean() <= 0.05, (d > 1e-3).mean()


def test_fused_frame_reads_the_pbr_atlas():
    """wave's plane takes its roughness from texel 0 of a 2x2048 PBR atlas
    (texture number 0), not from its inline value: the fetch's index
    arithmetic runs, and the plane's pixels carry the texel's roughness
    in render_id[1] (bounce 0 is their only first-surface bounce)."""
    scene, camera = build("wave", port)
    tb = build_scene_buffers(scene, "cpu")
    assert tuple(tb.pbr_atlas.shape) == (2, 2048, 3) and F.fused_eligible(tb)
    # material row 28 (attributes 16): the PBR texture number of each drawn
    # triangle; the plane's two are 0, the pillars' -1
    assert (tb.attributes[tb.id_buffer.long(), 16] == 0.0).sum() == 2
    cfg = _config("counter", 2)
    got = render_mrt(tb, SIZE, SIZE, camera.position, camera.view_matrix(SIZE, SIZE), cfg,
                     0.0, scheme="fused", kernels=PLAIN)
    rough = got.render_id[:, 1].numpy()
    texel = np.float32(tb.pbr_tab.texels[0, 0]) * np.float32(1.0 / 255.0) \
        if tb.pbr_tab.texels.dtype == torch.uint8 else np.float32(tb.pbr_tab.texels[0, 0])
    assert texel == np.float32(0.7)
    assert 0.2 < (rough == texel).mean() < 1.0


@pytest.mark.parametrize("name,spp", [("wave", 1), ("wave", 2), ("example2", 1),
                                      ("example2", 2)])
def test_fused_equals_fused_split_on_plain(name, spp):
    scene, camera = build(name, port)
    tb = build_scene_buffers(scene, "cpu")
    cfg = _config("counter", spp=spp)
    pos, view = camera.position, camera.view_matrix(SIZE, SIZE)
    a = render_mrt(tb, SIZE, SIZE, pos, view, cfg, 2.0, scheme="fused", kernels=PLAIN)
    b = render_mrt(tb, SIZE, SIZE, pos, view, cfg, 2.0, scheme="fused_split", kernels=PLAIN)
    for ch in a._fields:
        assert torch.equal(getattr(a, ch), getattr(b, ch)), ch


@pytest.mark.parametrize("name,eligible", [("cornell", True), ("theater", False),
                                           ("wave", True), ("example2", True)])
def test_fused_eligible_agrees_with_flexlight_tpu(name, eligible):
    jb, tb, _ = both_buffers(name)
    assert jax_fused_eligible(jb) == F.fused_eligible(tb) == eligible


def test_fused_refuses_what_it_cannot_serve():
    """theater's atlases hold up to 1536x2048 texels: the scheme raises and
    says why; so does the shading kernels' switch, which shades the
    bounces of other schemes."""
    cfg = _config("counter", 2)
    scene, camera = build("theater", port)
    tb = build_scene_buffers(scene, "cpu")
    with pytest.raises(ValueError, match=r"20 triangles .* 9 lights .* \[1048576, 3145728"):
        render_mrt(tb, 8, 8, camera.position, camera.view_matrix(8, 8), cfg, 0.0,
                   scheme="fused", kernels=PLAIN)
    scene, camera = build("wave", port)
    tb = build_scene_buffers(scene, "cpu")
    with pytest.raises(ValueError, match="shade_kernel"):
        render_mrt(tb, 8, 8, camera.position, camera.view_matrix(8, 8), cfg, 0.0,
                   scheme="fused", kernels=PLAIN, shade_kernel=True)


def test_auto_never_takes_fused_and_the_renderer_renders_it():
    """"auto" keeps flexlight_tpu's rule (fused_split below 1024
    triangles), on wave as on the other eligible scenes; asked for,
    scheme="fused" renders the full pipeline, the same frame as
    fused_split."""
    cfg = port.Config(temporal=True, temporal_samples=2, filter=True, antialiasing="fxaa",
                      max_reflections=2, rng="counter")
    for name in ("cornell", "example2"):
        scene, camera = build(name, port)
        assert PathTracer(8, 8, scene, camera, cfg, "cpu").resolved_scheme() == "fused_split"
    scene, camera = build("wave", port)
    frames = {}
    for scheme in ("auto", "fused", "fused_split"):
        pt = PathTracer(12, 8, scene, camera, cfg, "cpu", scheme=scheme)
        frames[scheme] = pt.render_frame()
        assert pt.metrics.last["scheme"] == ("fused_split" if scheme == "auto" else scheme)
    assert frames["fused"].max() > 0
    np.testing.assert_array_equal(frames["fused"], frames["fused_split"])
