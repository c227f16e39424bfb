"""The port's scan and packet casts (ops/traverse.py, plain PyTorch)
against flexlight_tpu's (ops/traverse.py, plain XLA) on the same rays:
cornell's camera rays and seeded random rays, closest hit with the edge
window at +BIAS and -BIAS and the culled any hit.

The triangle ids must be identical on every ray that is not a knife edge
(`knife_edge_rays`): the two packages round the Moeller-Trumbore sums in
other orders (XLA on the CPU may fuse a multiply and an add), so a ray
whose test sits within rounding of a window edge, or that finds two
triangles at nearly the same s, may go either way. Where the ids agree,
s / u / v agree to 1e-5 (relative for s). The path tracer's MRT on both
schemes is held the same way, pixel by pixel, against flexlight_tpu's."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from flexlight_tpu.ops import buffers as jbuf  # noqa: E402
from flexlight_tpu.ops import traverse as jtrv  # noqa: E402
from flexlight_tpu.ops.geometry import world_geometry as jworld  # noqa: E402
from flexlight_tpu.ops.pathtrace import camera_rays as jcamera_rays  # noqa: E402
from flexlight_tpu_torch.ops import intersect_kernel as tik  # noqa: E402
from flexlight_tpu_torch.ops import traverse as ttrv  # noqa: E402
from flexlight_tpu_torch.ops.buffers import buffers_from_numpy  # noqa: E402
from flexlight_tpu_torch.ops.geometry import world_geometry as tworld  # noqa: E402
from flexlight_tpu_torch.ops.intersect import BIAS, POW32, mt_products  # noqa: E402
from tests.scenes import cornell_scene  # noqa: E402

SIZE = 24
TILE = 64
# how close to a test's edge two float32 implementations may round a pair
# apart: the u / v window (absolute), s against BIAS (absolute: a shadow
# ray leaving its surface finds it at |s| <= ~2e-6, next to BIAS = 1.5e-5),
# s against max_len and two nearest hits (relative), det against BIAS
EPS_UV, EPS_S, EPS_REL, EPS_DET = 1e-5, 5e-6, 1e-5, 1e-3


def knife_edge_rays(w4, o3, d3, max_len, edge: float, any_hit: bool):
    """bool [N]: rays that two float32 implementations may decide apart.
    A (ray, triangle) pair is on a knife edge when no test of its accept
    window rejects it by more than that test's EPS_* and one passes or
    fails by less; a closest-hit ray also when its two nearest accepted
    triangles lie within EPS_REL * max(1, s)."""
    d3 = tik._safe_dirs(d3)
    ml = max_len[:, None]
    det, udet, vdet, sdet = mt_products(w4, o3, d3)
    inv = 1.0 / det
    u, v, s = udet * inv, vdet * inv, sdet * inv
    lo = BIAS if any_hit else edge
    margins = [((det if any_hit else torch.abs(det)) - BIAS) / EPS_DET,
               (u - lo) / EPS_UV, (1.0 - u) / EPS_UV, (v - lo) / EPS_UV,
               (1.0 - (u + v)) / EPS_UV, (s - BIAS) / EPS_S,
               (ml - s) / (EPS_REL * torch.clamp_min(ml, 1.0))]
    margins = [torch.nan_to_num(m, nan=-2.0) for m in margins]
    rejected = torch.stack([m < -1.0 for m in margins]).any(dim=0)
    near = torch.stack([m.abs() <= 1.0 for m in margins]).any(dim=0)
    tie = (near & ~rejected).any(dim=-1)
    if not any_hit and s.shape[1] > 1:
        valid = torch.stack([m >= 0 for m in margins]).all(dim=0)
        two = torch.where(valid, s, torch.full_like(s, POW32)).topk(2, largest=False).values
        tie |= (two[:, 1] < POW32) & (two[:, 1] - two[:, 0] <= EPS_REL * two[:, 0].clamp_min(1.0))
    return tie


def _soa(x):
    return tuple(torch.from_numpy(np.ascontiguousarray(x[:, c])) for c in range(3))


@pytest.fixture(scope="module")
def case():
    """Cornell's world geometry on both sides, its camera rays, and seeded
    random rays from inside the box, each with random lengths for the any
    hit. Cornell's walls are quads split along a diagonal that its 24 x 24
    camera rays graze: ~6% of them are knife edges."""
    scene, camera = cornell_scene()
    jb = jbuf.build_scene_buffers(scene)
    tb = buffers_from_numpy(jax.tree.map(np.asarray, jb), "cpu")
    jw = jworld(jb)
    tw = tworld(tb)
    o, d, _ = jcamera_rays(SIZE, SIZE, jnp.asarray(camera.position),
                           jnp.asarray(camera.view_matrix(SIZE, SIZE)))
    rng = np.random.default_rng(5)
    n = 1024
    ro = rng.uniform(-4.9, 4.9, (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    rl = rng.uniform(0.0, 12.0, n).astype(np.float32)
    cl = rng.uniform(0.0, 40.0, SIZE * SIZE).astype(np.float32)
    w4, _ = tik.build_w4(tw, tb.id_buffer)
    return dict(jw=jw, tw=tw, w4=w4, rays={"camera": (np.array(o), np.array(d), cl),
                                           "random": (ro, rd, rl)})


def _check_closest(case, ref, got, o, d, edge):
    tie = knife_edge_rays(case["w4"], _soa(o), _soa(d), torch.full((o.shape[0],), POW32),
                          edge, False).numpy()
    jt, tt = np.asarray(ref.triangle), got.triangle.numpy()
    assert (jt[~tie] == tt[~tie]).all(), np.nonzero((jt != tt) & ~tie)
    assert tie.mean() <= 0.1, tie.mean()
    same = jt == tt
    js, ts = np.asarray(ref.suv)[same], got.suv.numpy()[same]
    np.testing.assert_allclose(ts[:, 0], js[:, 0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ts[:, 1:], js[:, 1:], atol=1e-5)
    assert (tt >= 0).mean() > 0.3


def _check_any(case, ref, got, o, d, max_len):
    tie = knife_edge_rays(case["w4"], _soa(o), _soa(d), torch.from_numpy(max_len), BIAS,
                          True).numpy()
    ref, got = np.asarray(ref), got.numpy()
    assert (ref[~tie] == got[~tie]).all(), np.nonzero((ref != got) & ~tie)
    assert tie.mean() <= 0.05, tie.mean()
    assert 0.05 < got.mean() < 0.95


@pytest.mark.parametrize("rays", ["camera", "random"])
@pytest.mark.parametrize("edge", [BIAS, -BIAS])
def test_scan_closest_hit_matches(case, rays, edge):
    o, d, _ = case["rays"][rays]
    ref = jtrv.traverse_scan(case["jw"], jnp.asarray(o), jnp.asarray(d), edge=edge)
    got = ttrv.traverse_scan(case["tw"], torch.from_numpy(o), torch.from_numpy(d), edge=edge)
    _check_closest(case, ref, got, o, d, edge)


@pytest.mark.parametrize("rays", ["camera", "random"])
@pytest.mark.parametrize("edge", [BIAS, -BIAS])
def test_packet_closest_hit_matches(case, rays, edge):
    o, d, _ = case["rays"][rays]
    ref = jtrv.traverse_coherent(case["jw"], jnp.asarray(o), jnp.asarray(d), tile=TILE,
                                 edge=edge)
    got = ttrv.traverse_coherent(case["tw"], torch.from_numpy(o), torch.from_numpy(d),
                                 tile=TILE, edge=edge)
    _check_closest(case, ref, got, o, d, edge)


@pytest.mark.parametrize("scheme", ["scan", "packet"])
@pytest.mark.parametrize("rays", ["camera", "random"])
def test_shadow_any_hit_matches(case, scheme, rays):
    o, d, max_len = case["rays"][rays]
    if scheme == "scan":
        ref = jtrv.shadow_scan(case["jw"], jnp.asarray(o), jnp.asarray(d),
                               jnp.asarray(max_len))
        got = ttrv.shadow_scan(case["tw"], *(torch.from_numpy(x) for x in (o, d, max_len)))
    else:
        ref = jtrv.shadow_coherent(case["jw"], jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(max_len), tile=TILE)
        got = ttrv.shadow_coherent(case["tw"], *(torch.from_numpy(x) for x in (o, d, max_len)),
                                   tile=TILE)
    _check_any(case, ref, got, o, d, max_len)


def test_packet_needs_whole_tiles(case):
    o, d, _ = case["rays"]["random"]
    with pytest.raises(ValueError, match="whole tiles"):
        ttrv.traverse_coherent(case["tw"], torch.from_numpy(o[:100]),
                               torch.from_numpy(d[:100]), tile=TILE)


@pytest.mark.parametrize("scheme", ["scan", "packet"])
def test_render_mrt_on_scan_and_packet_matches(monkeypatch, scheme):
    """The path tracer's MRT on scheme="scan" / "packet" (the bounce loop
    around these casts) against flexlight_tpu's on the same scheme, cornell
    at 16 x 16, counter RNG, 2 bounces: 1e-5 on every pixel none of whose
    casts (primary, bounce and shadow, recorded) is a knife edge."""
    from flexlight_tpu import Config
    from flexlight_tpu.ops.pathtrace import render_mrt as jrender
    from flexlight_tpu_torch.ops import pathtrace as tpt

    size = 16
    scene, camera = cornell_scene()
    jb = jbuf.build_scene_buffers(scene)
    tb = buffers_from_numpy(jax.tree.map(np.asarray, jb), "cpu")
    cfg = Config(temporal=False, filter=False, antialiasing=None, max_reflections=2,
                 rng="counter")
    view = camera.view_matrix(size, size)
    ref = jrender(jb, size, size, jnp.asarray(camera.position), jnp.asarray(view), cfg,
                  jnp.float32(0.0), scheme=scheme, tile=TILE)
    casts = []
    real = tpt.scheme_casts

    def recording(*args):
        traverse, shadow = real(*args)

        def closest(o3, d3, alive=None, edge=BIAS, bounce=False):
            casts.append((False, o3, d3, torch.full_like(o3[0], POW32), edge))
            return traverse(o3, d3, alive=alive, edge=edge, bounce=bounce)

        def any_hit(o3, d3, max_len, alive=None, bounce=False):
            casts.append((True, o3, d3, max_len, BIAS))
            return shadow(o3, d3, max_len, alive=alive, bounce=bounce)

        return closest, any_hit

    monkeypatch.setattr(tpt, "scheme_casts", recording)
    got = tpt.render_mrt(tb, size, size, camera.position, view, cfg, 0.0, scheme=scheme,
                         tile=TILE)
    w4, _ = tik.build_w4(tworld(tb), tb.id_buffer)
    tie = torch.zeros(size * size, dtype=torch.bool)
    for any_hit, o3, d3, max_len, edge in casts:
        tie |= knife_edge_rays(w4, tuple(c.contiguous() for c in o3),
                               tuple(c.contiguous() for c in d3), max_len.contiguous(), edge,
                               any_hit)
    assert tie.float().mean() <= 0.15
    for field in ref._fields:
        a = np.asarray(getattr(ref, field)).reshape(size * size, -1)
        b = getattr(got, field).numpy().reshape(size * size, -1)
        assert float(np.abs(a - b).max(axis=-1)[~tie.numpy()].max()) <= 1e-5, field
    assert float(got.alpha.mean()) > 0.5
