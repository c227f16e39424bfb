"""The port's sparse worklist casts (ops.intersect_sparse and the plain
versions of csrc/sparse.cu in ops.intersect_sparse_kernel) against
flexlight_tpu/ops/intersect_sparse.py, and the CUDA sources built for the
host (-DFL_EMULATE) against their plain versions.

- The tile flags and the nearest2 sort key take the JAX package's float
  operations in its order: equal to `_tmins_xla` / `flags_sparse` and to
  `_nearest2_key_xla` / `nearest2_key` (interpret mode), exactly.
- Closest hit and any hit: flexlight_tpu decides its accept window on
  bf16x6 products in the det domain, the port on float32 k-order products,
  so a ray may be decided apart where a triangle lies within the rounding
  of the products of a window edge, or two candidates within it of each
  other (`tie_rays`). Only those rays may differ, and they stay under 0.5%.
  Where both pick the same triangle, s agrees to rtol 1e-5 / atol 1e-6,
  and u and v to that plus VALUE_ULPS times their float32 rounding bound
  (`rounding`): they are ratios of 16-term sums with cancellation, and the
  two packages sum in other orders.
- The wavefront sort and the ray tile only group work: results are
  identical with and without them.
- Emulated kernels: identical to their plain versions."""

import shutil

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from flexlight_tpu.ops import intersect_sparse as J  # noqa: E402
from flexlight_tpu_torch import _native  # noqa: E402
from flexlight_tpu_torch.ops import intersect_kernel as IK  # noqa: E402
from flexlight_tpu_torch.ops import intersect_sparse as S  # noqa: E402
from flexlight_tpu_torch.ops import intersect_sparse_kernel as K  # noqa: E402
from flexlight_tpu_torch.ops.intersect import BIAS, POW32, mt_products  # noqa: E402
from flexlight_tpu_torch.scenes import stand_in_mesh  # noqa: E402
from test_torch_sparse_record import RING, walk_scene  # noqa: E402  (as pytest collects it)

ULP = 2.0 ** -24
TIE_ULPS = 16        # rounding margin of a decision, in units of `rounding`
VALUE_ULPS = 2       # margin of u and v beyond rtol / atol, in units of `rounding`
MAX_TIES = 0.005


def _t3(a):
    return tuple(torch.from_numpy(np.ascontiguousarray(a[:, c])) for c in range(3))


def _j3(a):
    return tuple(jnp.asarray(a[:, c]) for c in range(3))


def _boxes(seed, k):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10, 10, (k, 3)).astype(np.float32)
    half = rng.uniform(0.2, 3.0, (k, 3)).astype(np.float32)
    return centers - half, centers + half


def _rays(seed, n, spread=12.0, dead=0.3):
    """Seeded rays: axis-aligned and zero directions among them, `dead`
    of them dead (max_len 0), the last ray tiles entirely dead."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[::17] = np.array([0.0, 1.0, 0.0])
    d[::23] = 0.0
    ml = np.full(n, POW32, dtype=np.float32)
    ml[rng.uniform(size=n) < dead] = 0.0
    ml[n - n // 4:] = 0.0
    return o, d, ml


def test_flags_plain_matches_jax():
    amin, amax = _boxes(21, 42)
    o, d, ml = _rays(22, 3072)
    o3, d3, mlp, n = S._prep_soa(_t3(o), _t3(d), torch.from_numpy(ml), 128)
    got = K.flags_plain(torch.from_numpy(amin), torch.from_numpy(amax), o3, d3, mlp, 128)
    po = jnp.asarray(np.stack([c.numpy() for c in o3], -1))
    pd = jnp.asarray(np.stack([c.numpy() for c in d3], -1))
    args = (jnp.asarray(amin), jnp.asarray(amax), po, pd, jnp.asarray(mlp.numpy()))
    ref = J._tmins_xla(*args, n // 128, 21, 128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    kern = J.flags_sparse(*args, tri_tile=128, ray_tile=128, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(kern))
    assert (got.numpy()[-6:] == POW32).all()           # all-dead ray tiles
    assert (got.numpy()[:-6] < POW32).any()


def test_nearest2_key_plain_matches_jax():
    amin, amax = _boxes(23, 255)                       # 32 supertiles
    o, d, ml = _rays(24, 3000)
    got = K.nearest2_key_plain(*S._super_boxes(torch.from_numpy(amin), torch.from_numpy(amax)),
                               _t3(o), _t3(d), torch.from_numpy(ml)).numpy()
    args = (jnp.asarray(amin), jnp.asarray(amax), jnp.asarray(o), jnp.asarray(d),
            jnp.asarray(ml))
    np.testing.assert_array_equal(got, np.asarray(J._nearest2_key_xla(*args)))
    # the kernel's cross-chunk merge of the best two (k_chunk 8: 4 chunks)
    np.testing.assert_array_equal(got, np.asarray(J.nearest2_key(*args, interpret=True,
                                                                 k_chunk=8)))
    assert (got[ml <= 0] == K.DEAD_KEY).all() and (got[ml > 0] < K.DEAD_KEY).all()


@pytest.fixture(scope="module")
def mesh():
    """A closed seeded mesh of 2064 triangles (17 tiles) in a reversed
    drawable order, on both sides, and seeded rays around it."""
    v, _, f = stand_in_mesh(np.random.default_rng(3), 24, 44, (3.0, 2.0, 2.0), 0.0, 0.15)
    tris = v[f - 1].reshape(-1, 9).astype(np.float32)
    t = tris.shape[0]
    wg = np.zeros((t, 12), np.float32)
    wg[:, :9] = tris
    ids = np.arange(t, dtype=np.int32)[::-1].copy()
    rng = np.random.default_rng(4)
    n = 2048
    o = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return dict(t=t, port=S.build_tiled(torch.from_numpy(wg), torch.from_numpy(ids)),
                w4=IK.build_w4(torch.from_numpy(wg), torch.from_numpy(ids))[0],
                jax=J.build_w4_tiled(jnp.asarray(wg), jnp.asarray(ids)),
                o=o, d=d, alive=rng.uniform(size=n) < 0.8,
                length=rng.uniform(0, 8, n).astype(np.float32))


def rounding(w4, o3, d3):
    """(det, u, v, s, and their float32 rounding bounds), each [N, T]: one
    ulp of the sum of the absolute terms of each product, carried through
    the quotients."""
    d3 = IK._safe_dirs(d3)
    det, udet, vdet, sdet = mt_products(w4, o3, d3)
    mag = mt_products(w4.abs(), tuple(c.abs() for c in o3), tuple(c.abs() for c in d3))
    e_det, e_u, e_v, e_s = (m * ULP for m in mag)
    inv = 1.0 / det
    u, v, s = udet * inv, vdet * inv, sdet * inv
    ad = det.abs()
    return (det, u, v, s, e_det, (e_u + u.abs() * e_det) / ad, (e_v + v.abs() * e_det) / ad,
            (e_s + s.abs() * e_det) / ad)


def tie_rays(w4, o3, d3, max_len, edge: float, any_hit: bool):
    """bool [N]: rays that two float32 implementations of the test may
    decide apart. A (ray, triangle) pair is on a knife edge where the
    accept window widened by TIE_ULPS rounding bounds takes it and the
    window narrowed by them does not; a closest hit is one too where its
    two nearest candidates lie within their bounds of each other."""
    det, u, v, s, e_det, e_u, e_v, e_s = rounding(w4, o3, d3)
    lo = BIAS if any_hit else edge
    ml = max_len[:, None]

    def window(sign):
        m = sign * TIE_ULPS
        dd = det if any_hit else det.abs()
        ok = dd >= BIAS - m * e_det
        ok &= (u >= lo - m * e_u) & (u <= 1.0 + m * e_u)
        ok &= (v >= lo - m * e_v) & (u + v <= 1.0 + m * (e_u + e_v))
        return ok & (s > BIAS - m * e_s) & (s <= ml + m * e_s)

    wide = window(1.0)
    tie = (wide & ~window(-1.0)).any(dim=-1)
    if not any_hit:
        two = torch.where(wide, s, POW32).topk(2, largest=False)
        gap = two.values[:, 1] - two.values[:, 0]
        margin = TIE_ULPS * torch.gather(e_s, 1, two.indices).sum(dim=1)
        tie |= (two.values[:, 1] < POW32) & (gap <= margin)
    return tie


@pytest.mark.parametrize("cast", ["primary", "bounce"])
def test_closest_hit_matches_jax(mesh, cast):
    """traverse_sparse_soa of both packages; the bounce cast is sorted by
    the nearest2 key on both sides (flexlight_tpu's default for hinted
    casts), the primary is not."""
    edge, sort = (-BIAS, False) if cast == "primary" else (BIAS, True)
    o, d, alive = mesh["o"], mesh["d"], mesh["alive"]
    n = len(o)
    w4t, amin, amax, w4f = mesh["jax"]
    ref = J.traverse_sparse_soa(w4t, w4f, amin, amax, _j3(o), _j3(d), interpret=True,
                                sort_rays=sort, alive=jnp.asarray(alive), edge=edge,
                                sort_hint=jnp.zeros(n, jnp.int32) if sort else None,
                                sort_mode="nearest2")
    got = S.traverse_sparse_soa(mesh["port"], _t3(o), _t3(d), alive=torch.from_numpy(alive),
                                edge=edge, sort_rays=sort)
    ml = torch.from_numpy(np.where(alive, POW32, 0.0).astype(np.float32))
    w4 = mesh["w4"]
    ties = tie_rays(w4, _t3(o), _t3(d), ml, edge, any_hit=False).numpy()
    tri, rtri = got[3].numpy(), np.asarray(ref[3])
    diff = tri != rtri
    print(f"{cast}: {int((tri >= 0).sum())} hits, {int(diff.sum())} rays differ, "
          f"{int(ties.sum())} in the tie set")
    assert not (diff & ~ties).any(), np.flatnonzero(diff & ~ties)
    assert ties.mean() <= MAX_TIES and (tri >= 0).sum() > 50
    same = ~diff & (tri >= 0)
    _, _, _, _, _, e_u, e_v, _ = rounding(w4, _t3(o), _t3(d))
    col = torch.from_numpy(np.maximum(tri, 0)).long()[:, None]
    for name, a, b, e in zip("uv", got[1:3], ref[1:3], (e_u, e_v)):
        a, b = a.numpy()[same], np.asarray(b)[same]
        e = torch.gather(e, 1, col)[:, 0].numpy()[same]
        excess = np.abs(a - b) - (1e-6 + 1e-5 * np.abs(b))
        worst = np.max(excess / np.maximum(e, 1e-30))
        print(f"{name}: worst excess over rtol / atol {worst:.3f} rounding bounds")
        assert (excess <= VALUE_ULPS * e).all(), name
    np.testing.assert_allclose(got[0].numpy()[same], np.asarray(ref[0])[same], rtol=1e-5,
                               atol=1e-6)


def test_any_hit_matches_jax(mesh):
    o, d, alive, length = mesh["o"], mesh["d"], mesh["alive"], mesh["length"]
    n = len(o)
    w4t, amin, amax, _ = mesh["jax"]
    ref = np.asarray(J.shadow_sparse_soa(w4t, amin, amax, _j3(o), _j3(d), jnp.asarray(length),
                                         interpret=True, sort_rays=True,
                                         alive=jnp.asarray(alive),
                                         sort_hint=jnp.zeros(n, jnp.int32),
                                         sort_mode="nearest2"))
    got = S.shadow_sparse_soa(mesh["port"], _t3(o), _t3(d), torch.from_numpy(length),
                              alive=torch.from_numpy(alive), sort_rays=True).numpy()
    ml = torch.from_numpy(np.where(alive, length, 0.0).astype(np.float32))
    ties = tie_rays(mesh["w4"], _t3(o), _t3(d), ml, BIAS,
                    any_hit=True).numpy()
    diff = got != ref
    print(f"shadow: {int(got.sum())} hits, {int(diff.sum())} rays differ, "
          f"{int(ties.sum())} in the tie set")
    assert not (diff & ~ties).any() and ties.mean() <= MAX_TIES and got.sum() > 20


def test_sort_and_ray_tile_do_not_change_results(mesh):
    o3, d3 = _t3(mesh["o"]), _t3(mesh["d"])
    alive = torch.from_numpy(mesh["alive"])
    length = torch.from_numpy(mesh["length"])
    sc = mesh["port"]
    base = S.traverse_sparse_soa(sc, o3, d3, alive=alive)
    for kw in (dict(sort_rays=True), dict(ray_tile=32), dict(sort_rays=True, ray_tile=32)):
        for a, b in zip(S.traverse_sparse_soa(sc, o3, d3, alive=alive, **kw), base):
            assert torch.equal(a, b), kw
        assert torch.equal(S.shadow_sparse_soa(sc, o3, d3, length, alive=alive, **kw),
                           S.shadow_sparse_soa(sc, o3, d3, length, alive=alive))
    assert (base[3] >= 0).any()


@pytest.mark.skipif(shutil.which("g++") is None and shutil.which("c++") is None,
                    reason="no host C++ compiler for the emulated kernel build")
def test_emulated_kernels_are_bit_exact(mesh, tmp_path):
    """csrc/sparse.cu built for the host, launched through the wrappers'
    launch code: each of the four kernels identical to its plain version
    (the key over 300 supertile boxes: two of the kernel's box chunks); the
    casts also on `walk_scene`'s ray tiles: one whose rays 0-63 finish at
    slot 0 while rays 64-127 run to the end of a worklist longer than the
    ring, and worklists of one tile and of none."""
    lib = _native.build_library(tmp_path, emulate=True)
    sc = mesh["port"]
    o, d, ml = _rays(25, 1024, spread=5.0, dead=0.2)
    lengths = torch.from_numpy(np.where(ml > 0, mesh["length"][:1024], 0.0).astype(np.float32))
    for max_len, edge in ((torch.from_numpy(ml), -BIAS), (lengths, BIAS)):
        o3, d3, mlp, _ = S._prep_soa(_t3(o), _t3(d), max_len, 128)
        flags = K.flags_plain(sc.amin, sc.amax, o3, d3, mlp, 128)
        assert torch.equal(K._flags_launch(lib, 0, sc.amin, sc.amax, o3, d3, mlp, 128), flags)
        tlist, tms, counts = S._compact(flags)
        got = K._closest_launch(lib, 0, sc.rec, tlist, tms, counts, o3, d3, mlp, edge, 128)
        ref = K.closest_plain(sc.rec, tlist, tms, counts, o3, d3, mlp, edge, 128)
        assert all(torch.equal(a, b) for a, b in zip(got, ref)) and (ref[3] >= 0).any()
        hit = K._any_launch(lib, 0, sc.rec, tlist, counts, o3, d3, mlp, 128)
        assert torch.equal(hit, K.any_plain(sc.rec, tlist, counts, o3, d3, mlp, 128))
    ws, wo3, wd3, wml, wlen = walk_scene()
    for max_len, edge in ((wml, -BIAS), (wml, BIAS), (wlen, None)):
        o3, d3, mlp, _ = S._prep_soa(wo3, wd3, max_len, 128)
        tlist, tms, counts = S._compact(K.flags_plain(ws.amin, ws.amax, o3, d3, mlp, 128))
        assert counts.tolist() == [6, 1, 0, 0] and counts.max() > RING
        if edge is None:
            hit = K._any_launch(lib, 0, ws.rec, tlist, counts, o3, d3, mlp, 128)
            assert torch.equal(hit, K.any_plain(ws.rec, tlist, counts, o3, d3, mlp, 128))
            assert hit[32:64].all() and not hit[:32].any() and not hit[64:128].any()
            continue
        got = K._closest_launch(lib, 0, ws.rec, tlist, tms, counts, o3, d3, mlp, edge, 128)
        ref = K.closest_plain(ws.rec, tlist, tms, counts, o3, d3, mlp, edge, 128)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
        live = mlp[:128] > 0
        # rays 0-63 are done after slot 0, rays 64-127 find nothing
        assert (ref[3][:64] >= 0).eq(live[:64]).all() and (ref[3][64:128] == -1).all()
        assert float(ref[0][:64].max()) * K.EXIT_REL + K.EXIT_ABS < float(tms[0, 1])
    bmin, bmax = (torch.from_numpy(b) for b in _boxes(26, 300))
    o, d, ml = _rays(27, 700)
    assert torch.equal(K._key_launch(lib, 0, bmin, bmax, _t3(o), _t3(d), torch.from_numpy(ml)),
                       K.nearest2_key_plain(bmin, bmax, _t3(o), _t3(d), torch.from_numpy(ml)))
    with pytest.raises(ValueError):                    # not whole ray tiles
        K._flags_launch(lib, 0, sc.amin, sc.amax, o3, d3, mlp, 96)
