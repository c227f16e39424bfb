"""The port's closest hit / any hit (plain version of csrc/intersect.cu)
against flexlight_tpu's dense Pallas kernel (traverse_kernel_soa /
shadow_kernel_soa, interpret mode, as render_mrt(scheme="kernel") builds
it) and against its MXU formulation (traverse_mxu / shadow_mxu).

Hits must agree ray for ray away from floating-point ties. The bilinear
form's products are float32 sums in different orders in the three
implementations (the TPU kernel's bf16 limbs, XLA's dot, the port's
k-order sum), so a ray that meets a test edge within rounding (a shadow
ray leaving a surface seen from its back finds it at s ~ 0 next to the
BIAS edge; coplanar triangles meet along shared edges) may go either way:
`fp_tie_rays` names those rays, and only they may differ. Where both hit
the same triangle, s/u/v agree to 1e-3 (float32 rounding of the products,
amplified by 1/det)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from flexlight_tpu.ops import buffers as jbuf  # noqa: E402
from flexlight_tpu.ops import intersect_kernel as jik  # noqa: E402
from flexlight_tpu.ops.geometry import world_geometry as jworld  # noqa: E402
from flexlight_tpu.ops.pathtrace import camera_rays as jcamera_rays  # noqa: E402
from flexlight_tpu.ops.traverse_mxu import build_tri_matrix, shadow_mxu, traverse_mxu  # noqa: E402
from flexlight_tpu_torch.ops import buffers as tbuf  # noqa: E402
from flexlight_tpu_torch.ops import intersect_kernel as tik  # noqa: E402
from flexlight_tpu_torch.ops.geometry import world_geometry as tworld  # noqa: E402
from flexlight_tpu_torch.ops.intersect import BIAS, POW32, mt_products  # noqa: E402
from flexlight_tpu_torch.scenes import stand_in_wood_texture, theater  # noqa: E402
from tests.scenes import cornell_scene  # noqa: E402

SIZE = 24


def _scene(name):
    if name == "cornell":
        return cornell_scene()
    e = theater(stand_in_wood_texture(0), device="cpu")
    return e.scene, e.camera


@pytest.fixture(scope="module", params=["cornell", "theater"])
def case(request):
    """Scene buffers on both sides plus three seeded wavefronts: camera
    primaries (edge -BIAS), random bounce rays (10% dead) and random
    shadow rays with random lengths."""
    scene, camera = _scene(request.param)
    jb = jbuf.build_scene_buffers(scene)
    tb = tbuf.build_scene_buffers(scene, "cpu")
    jw = jworld(jb)
    w4, ids = tik.build_w4(tworld(tb), tb.id_buffer)
    o, d, _ = jcamera_rays(SIZE, SIZE, jnp.asarray(camera.position),
                           jnp.asarray(camera.view_matrix(SIZE, SIZE)))
    o, d = np.asarray(o), np.asarray(d)
    rng = np.random.default_rng(11)
    n = 2048
    lo, hi = np.asarray(jw[:, 0:9]).min(), np.asarray(jw[:, 0:9]).max()
    ro = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    alive = rng.uniform(size=n) > 0.1
    rl = rng.uniform(0, hi - lo, n).astype(np.float32)
    return dict(jb=jb, jw=jw, w4=w4, ids=ids, prim=(o, d), rand=(ro, rd, alive, rl))


TIE_EPS = 1e-4


def fp_tie_rays(w4, o3, d3, max_len, edge: float, any_hit: bool):
    """Rays whose result two float32 implementations may decide apart.

    The accept window and the closest-hit choice are knife edges: a ray
    can find a triangle's u, v, u+v or s within rounding of a threshold
    (a shadow ray leaving a surface seen from its back finds that surface
    at s ~ 0, next to the BIAS edge), or two triangles at nearly the same s
    (coplanar triangles along a shared edge). Returns bool [N]: the rays
    with some triangle within TIE_EPS of an edge of its test (relative for
    s against max_len, absolute otherwise), or, for a closest hit, with
    its two nearest valid triangles within TIE_EPS * max(1, s)."""
    eps = TIE_EPS
    d3 = tik._safe_dirs(d3)
    ml = max_len[:, None]
    det, udet, vdet, sdet = mt_products(w4, o3, d3)
    inv = 1.0 / det
    u, v, s = udet * inv, vdet * inv, sdet * inv
    lo = BIAS if any_hit else edge
    near = ((u - lo).abs() <= eps) | ((v - lo).abs() <= eps)
    near |= ((u - 1.0).abs() <= eps) | ((u + v - 1.0).abs() <= eps)
    near |= ((s - BIAS).abs() <= eps) | ((s - ml).abs() <= eps * ml.clamp_min(1.0))
    near |= det.abs() <= 1e-3
    tie = near.any(dim=-1)
    if not any_hit and s.shape[1] > 1:
        valid = (det.abs() >= BIAS) & (u >= edge) & (u <= 1.0) & (v >= edge)
        valid &= (u + v <= 1.0) & (s > BIAS) & (s <= ml)
        two = torch.where(valid, s, torch.full_like(s, POW32)).topk(2, largest=False).values
        tie |= (two[:, 1] < POW32) & (two[:, 1] - two[:, 0] <= eps * two[:, 0].clamp_min(1.0))
    return tie


def _t3(a):
    return tuple(torch.from_numpy(np.ascontiguousarray(a[:, c])) for c in range(3))


def _j3(a):
    return tuple(jnp.asarray(a[:, c]) for c in range(3))


def _closest(case, o, d, alive, edge):
    ml = torch.from_numpy(np.where(alive, POW32, 0.0).astype(np.float32))
    got = tik.closest_hit_plain(case["w4"], case["ids"], _t3(o), _t3(d), ml, edge)
    ties = fp_tie_rays(case["w4"], _t3(o), _t3(d), ml, edge, any_hit=False)
    return got, ties.numpy()


def _check_closest(got, ties, ref_s, ref_u, ref_v, ref_tri):
    tri = got[3].numpy()
    diff = tri != np.asarray(ref_tri)
    assert not (diff & ~ties).any(), np.flatnonzero(diff & ~ties)
    assert diff.mean() <= 0.01
    same = ~diff & (tri >= 0)
    for a, b in zip(got[:3], (ref_s, ref_u, ref_v)):
        np.testing.assert_allclose(a.numpy()[same], np.asarray(b)[same], rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("x6", [False, True])
@pytest.mark.parametrize("cast", ["primary", "bounce"])
def test_closest_hit_matches_pallas_kernel(case, x6, cast):
    """traverse_kernel_soa in interpret mode, f32 (x6=False) or the bf16
    x6-limb W the kernel scheme uses (x6=True)."""
    if cast == "primary":
        (o, d), alive, edge = case["prim"], np.ones(SIZE * SIZE, bool), -BIAS
    else:
        (o, d, alive, _), edge = case["rand"], BIAS
    tt = jik.pick_tri_tile(case["jb"].id_buffer.shape[0])
    w4, amin, amax, ids = jik.build_w4(case["jw"], case["jb"].id_buffer, tt, x6=x6)
    ref = jik.traverse_kernel_soa(w4, amin, amax, ids, _j3(o), _j3(d), interpret=True,
                                  tri_tile=tt, alive=jnp.asarray(alive), edge=edge)
    got, ties = _closest(case, o, d, alive, edge)
    _check_closest(got, ties, *ref)


def test_closest_hit_matches_mxu(case):
    o, d, alive, _ = case["rand"]
    w = build_tri_matrix(case["jw"], case["jb"].id_buffer)
    ref = traverse_mxu(w, case["jb"].id_buffer, jnp.asarray(o), jnp.asarray(d))
    got, ties = _closest(case, o, d, np.ones(len(o), bool), BIAS)
    suv = np.asarray(ref.suv)
    _check_closest(got, ties, suv[:, 0], suv[:, 1], suv[:, 2], ref.triangle)


def _any(case, o, d, ml):
    got = tik.any_hit_plain(case["w4"], _t3(o), _t3(d), torch.from_numpy(ml)).numpy()
    ties = fp_tie_rays(case["w4"], _t3(o), _t3(d), torch.from_numpy(ml), BIAS,
                       any_hit=True).numpy()
    return got, ties


@pytest.mark.parametrize("x6", [False, True])
def test_any_hit_matches_pallas_kernel(case, x6):
    o, d, alive, rl = case["rand"]
    tt = jik.pick_tri_tile(case["jb"].id_buffer.shape[0])
    w4, amin, amax, ids = jik.build_w4(case["jw"], case["jb"].id_buffer, tt, x6=x6)
    ref = np.asarray(jik.shadow_kernel_soa(w4, amin, amax, ids, _j3(o), _j3(d),
                                           jnp.asarray(rl), interpret=True, tri_tile=tt,
                                           alive=jnp.asarray(alive)))
    got, ties = _any(case, o, d, np.where(alive, rl, 0.0).astype(np.float32))
    assert got.any()
    diff = got != ref
    assert not (diff & ~ties).any()
    assert diff.mean() <= 0.01


def test_any_hit_matches_mxu(case):
    o, d, _, rl = case["rand"]
    w = build_tri_matrix(case["jw"], case["jb"].id_buffer)
    ref = np.asarray(shadow_mxu(w, jnp.asarray(o), jnp.asarray(d), jnp.asarray(rl)))
    got, ties = _any(case, o, d, rl)
    diff = got != ref
    assert not (diff & ~ties).any()
    assert diff.mean() <= 0.01


def test_dead_rays_and_zero_directions_hit_nothing(case):
    """max_len 0 is a dead ray; a zero direction is cast as +z (the TPU
    kernel's ray prep) and, with max_len 0, hits nothing either."""
    o, d, _, _ = case["rand"]
    d = d.copy()
    d[::2] = 0.0
    ml = torch.zeros(len(o))
    s, u, v, tri = tik.closest_hit_plain(case["w4"], case["ids"], _t3(o), _t3(d), ml)
    assert (tri.numpy() == -1).all() and (s.numpy() == 0).all()
    assert not tik.any_hit_plain(case["w4"], _t3(o), _t3(d), ml).any()
