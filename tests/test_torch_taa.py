"""The port's TAA (post/taa.py) against flexlight_tpu's: the clamp and the
history average on a seeded history over 11 pushes (the 9-frame ring
wraps), the jitter sequence, and the path tracer's TAA tail
(postprocess_mrt with antialiasing="taa") over 3 frames of MRTs that
flexlight_tpu rendered, both sides starting from the same seeded history
(ops.buffers.taa_state_from_numpy).

Tolerances: the clamp, the average and the jitter take the same float
operations in the same order as flexlight_tpu's: identical. The TAA tail
of postprocess_mrt is held with the bound tests/test_torch_post.py holds
the post stack to (<= 1.5/255, <= 2% of values over 1e-4): the AA input
is the display quantized to rgba8, where a 1-ulp difference upstream
moves a value by one step."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from flexlight_tpu import Config  # noqa: E402
from flexlight_tpu.models import pathtracer as JP  # noqa: E402
from flexlight_tpu.ops import buffers as jbuf  # noqa: E402
from flexlight_tpu.ops.pathtrace import render_mrt as jrender  # noqa: E402
from flexlight_tpu.post import taa as jtaa  # noqa: E402
from flexlight_tpu.post.temporal import TemporalState as JTemporal  # noqa: E402
import flexlight_tpu_torch as port  # noqa: E402
from flexlight_tpu_torch.ops.buffers import taa_state_from_numpy  # noqa: E402
from flexlight_tpu_torch.ops.pathtrace import MRT  # noqa: E402
from flexlight_tpu_torch.post import chain as TP  # noqa: E402
from flexlight_tpu_torch.post import taa as ttaa  # noqa: E402
from flexlight_tpu_torch.post.temporal import TemporalState  # noqa: E402
from tests.scenes import cornell_scene  # noqa: E402

H, W = 12, 16


def _history(seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.1, 1.1, (ttaa.FRAMES, H, W, 4)).astype(np.float32)


def test_clamp_and_average_are_identical_over_a_wrapping_ring():
    rng = np.random.default_rng(2)
    jstate = jtaa.TAAState(history=jnp.asarray(_history(1)))
    tstate = taa_state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    for _ in range(11):
        frame = rng.uniform(0.0, 1.0, (H, W, 4)).astype(np.float32)
        frame[rng.uniform(size=(H, W)) < 0.2] = 0.0
        jlo, jhi = jtaa.neighborhood_clamp(jnp.asarray(frame))
        tlo, thi = ttaa.neighborhood_clamp(torch.from_numpy(frame))
        np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
        np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))
        jout, jstate = jtaa.taa_apply(jstate, jnp.asarray(frame))
        tout, tstate = ttaa.taa_apply(tstate, torch.from_numpy(frame))
        np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
        np.testing.assert_array_equal(tstate.history.numpy(), np.asarray(jstate.history))


@pytest.mark.parametrize("seed", [0, 3])
def test_jitter_sequences_are_identical(seed):
    np.testing.assert_array_equal(ttaa.gen_zero_sum_jitter(seed=seed),
                                  jtaa.gen_zero_sum_jitter(seed=seed))
    np.testing.assert_allclose(ttaa.gen_zero_sum_jitter(seed=seed).sum(axis=0), 0.0, atol=1e-12)
    jj, tj = jtaa.Jitter(seed), ttaa.Jitter(seed)
    for _ in range(2 * ttaa.FRAMES + 1):
        assert tj.next(W, H) == jj.next(W, H)


@pytest.fixture(scope="module")
def mrts():
    """Three frames' MRTs of cornell from flexlight_tpu (scheme "scan", a
    random seed each)."""
    scene, camera = cornell_scene()
    jb = jbuf.build_scene_buffers(scene)
    cfg = Config(temporal=False, filter=False, antialiasing=None, max_reflections=2)
    render = jax.jit(jrender, static_argnames=("width", "height", "config", "scheme"))
    return [render(jb, W, H, jnp.asarray(camera.position),
                   jnp.asarray(camera.view_matrix(W, H)), cfg, jnp.float32(seed),
                   scheme="scan") for seed in range(3)]


@pytest.mark.parametrize("temporal", [False, True])
def test_postprocess_taa_tail_matches(mrts, temporal):
    cfg = Config(temporal=temporal, temporal_samples=2, filter=False, antialiasing="taa")
    tcfg = port.Config(**vars(cfg))
    jtemp, ttemp = JTemporal.create(2, H, W), TemporalState.create(2, H, W, "cpu")
    jstate = jtaa.TAAState(history=jnp.asarray(_history(4)))
    tstate = taa_state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    for jm in mrts:
        tm = MRT(*(torch.from_numpy(np.array(x)) for x in jm))
        jout, jtemp, jstate = JP.postprocess_mrt(jm, jtemp, jstate, W, H, cfg)
        tout, ttemp, tstate = TP.postprocess_mrt(tm, ttemp, tstate, W, H, tcfg)
        d = np.abs(tout.numpy() - np.asarray(jout))
        assert float(d.max()) <= 1.5 / 255.0, d.max()
        assert float((d > 1e-4).mean()) <= 0.02, (d > 1e-4).mean()
        dh = np.abs(tstate.history.numpy() - np.asarray(jstate.history))
        assert float(dh.max()) <= 1.5 / 255.0
    assert tout.shape == (H, W, 3) and float(tout.mean()) > 0.05


@pytest.mark.parametrize("name", ["rasterizer", "pathtracer"])
def test_a_renderer_keeps_a_taa_history_only_under_taa(name):
    """The [9, H, W, 4] history (299 MB at 1080p) exists while antialiasing
    is "taa" and not under FXAA or none; a change of config re-prepares."""
    from tests.test_torch_scene_copy import build

    e = port.FlexLight((8, 6), device="cpu")
    e.scene, e.camera = build("cornell", port)
    e.renderer = name
    r = e.renderer
    for aa in ("fxaa", "taa", None, "taa"):
        r.config = port.Config(temporal=False, filter=False, antialiasing=aa)
        assert r.render_frame().shape == (6, 8, 3)
        if aa == "taa":
            assert r._taa_state.history.shape == (ttaa.FRAMES, 6, 8, 4)
        else:
            assert r._taa_state is None
