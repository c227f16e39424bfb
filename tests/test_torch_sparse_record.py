"""The worklist casts' triangle record and early rejects (csrc/sparse.cu,
ops.intersect_sparse.tri_record, ops.intersect_sparse_kernel).

- The record holds the distinct magnitudes of tri_rows' non-zero terms,
  and its four products equal `intersect.mt_products` (the
  64-term sums in k order) under torch.equal: rays with axis-aligned and
  zero directions, zero padding records among the triangles.
- Each early reject of the kernels takes only pairs that the accept window
  rejects: on pairs at the window's edges (det near +-BIAS, s near 0 and
  BIAS, u and v near 0 and 1, zeros of both signs, NaN), the rule itself
  and the host build of the kernels against their plain versions.
- `walk_scene`: a scene and rays whose ray tiles exercise the walk (a tile
  whose first rays finish at slot 0 while the others run to the end of a
  worklist longer than the ring, worklists of 0 and 1 tiles); the host
  build on it is held in tests/test_torch_sparse.py, the card in
  tests/test_torch_cuda.py.
- The Python copies of sparse.cu's lane and ring counts agree with it."""

import re
import shutil

import numpy as np
import pytest
import torch

from flexlight_tpu_torch import _native
from flexlight_tpu_torch.ops import intersect as I
from flexlight_tpu_torch.ops import intersect_sparse as S
from flexlight_tpu_torch.ops import intersect_sparse_kernel as K
from flexlight_tpu_torch.ops.intersect import BIAS, POW32

RING = 3             # csrc/sparse.cu FL_RING: tiles staged at once


def _grid(x0, x1, y0, y1, z, nx, ny):
    """nx x ny quads over [x0, x1] x [y0, y1] at height z as 2 nx ny
    triangles [.., 9], wound so that their normal is -z (a +z ray meets
    their front face)."""
    xs, ys = np.linspace(x0, x1, nx + 1), np.linspace(y0, y1, ny + 1)
    tris = []
    for i in range(nx):
        for j in range(ny):
            v00, v10 = (xs[i], ys[j], z), (xs[i + 1], ys[j], z)
            v01, v11 = (xs[i], ys[j + 1], z), (xs[i + 1], ys[j + 1], z)
            tris += [v00 + v01 + v11, v00 + v11 + v10]
    return tris


def walk_scene(seed=0, device="cpu"):
    """(SparseScene, o3, d3, max_len, lengths) for 4 ray tiles of 128 rays.

    Tile 0 of the triangles is an 8x8 grid over [-1, 1]^2 at z = 0; tiles
    1-5 are square frames over [-3, 3]^2 with a [-2, 2]^2 hole at z = 10,
    20, .., 50 (their cluster boxes span the hole). Rays start at z = -1
    heading +z:
    - ray tile 0: rays 0-63 hit the grid at s = 1 and are done after slot 0
      (the next entry bound is 11); rays 64-127 pass through the holes,
      enter every frame's box and hit nothing, so their warps run to the
      end of the 6-slot worklist; one dead ray and one zero direction (+z)
      among them;
    - ray tile 1: every ray hits the grid and ends at 5 (max_len), before
      the first frame: a worklist of one tile;
    - ray tile 2: every ray heads -z and enters nothing (no tile);
    - ray tile 3: dead rays.
    `lengths`: any-hit lengths, below the grid (0.5) for rays 0-31."""
    tris = _grid(-1, 1, -1, 1, 0.0, 8, 8)
    for k in range(1, 6):
        z = 10.0 * k
        tris += (_grid(-3, 3, 2, 3, z, 8, 2) + _grid(2, 3, -3, 3, z, 2, 8)
                 + _grid(-3, 3, -3, -2, z, 8, 2) + _grid(-3, -2, -3, 3, z, 2, 8))
    tris = np.asarray(tris, np.float32)
    wg = np.zeros((len(tris), 12), np.float32)
    wg[:, :9] = tris
    scene = S.build_tiled(torch.from_numpy(wg).to(device),
                          torch.arange(len(tris), dtype=torch.int32, device=device))
    rng = np.random.default_rng(seed)
    o = np.zeros((4, 128, 3), np.float32)
    o[:, :, 2] = -1.0
    o[:, :, :2] = rng.uniform(-0.9, 0.9, (4, 128, 2))
    o[0, 64:, :2] = rng.uniform(1.2, 1.8, (64, 2))
    d = np.zeros((4, 128, 3), np.float32)
    d[:, :, 2] = 1.0
    d[2, :, 2] = -1.0
    d[0, 100] = 0.0
    ml = np.full((4, 128), POW32, np.float32)
    ml[0, 5] = ml[0, 70] = 0.0
    ml[1] = 5.0
    ml[3] = 0.0
    lengths = np.where(ml > 0, np.minimum(ml, 100.0), 0.0).astype(np.float32)
    lengths[0, :32] = np.where(ml[0, :32] > 0, 0.5, 0.0)

    def soa(a):
        return tuple(torch.from_numpy(np.ascontiguousarray(a.reshape(-1, 3)[:, c])).to(device)
                     for c in range(3))

    return (scene, soa(o), soa(d), torch.from_numpy(ml.reshape(-1)).to(device),
            torch.from_numpy(lengths.reshape(-1)).to(device))


def _triangles(seed, t):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-4, 4, (t, 3))
    tris = np.concatenate([v0, v0 + rng.normal(size=(t, 3)), v0 + rng.normal(size=(t, 3))], 1)
    tris[::7, 6:9] = tris[::7, 3:6]            # degenerate: n = 0
    wg = np.zeros((t, 12), np.float32)
    wg[:, :9] = tris
    return torch.from_numpy(wg), torch.from_numpy(rng.permutation(t).astype(np.int32))


def test_record_products_equal_the_w_rows_products():
    wg, ids = _triangles(31, 300)
    rec = S.tri_record(wg, ids)
    det, udet, vdet, sdet = I.tri_rows(wg, ids)
    # the record's values are the rows' magnitudes, in their places
    n, v0n, c, g, e2, e1 = rec[:, 0:3], rec[:, 3], rec[:, 4:7], rec[:, 7:10], rec[:, 10:13], \
        rec[:, 13:16]
    assert torch.equal(det[:, 4:7], -n) and torch.equal(sdet[:, 1:4], n)
    assert torch.equal(sdet[:, 0], -v0n)
    assert torch.equal(udet[:, 4:7], -c) and torch.equal(vdet[:, 4:7], -g)
    assert torch.equal(udet[:, 7:16], I._skew(e2)) and torch.equal(vdet[:, 7:16], -I._skew(e1))
    # padding records: all zeros, as build_tiled pads its last tile
    scene = S.build_tiled(wg, ids)
    padded = scene.rec.reshape(-1, 16)
    assert torch.equal(padded[:300], rec) and not padded[300:].any()
    w4 = torch.cat([torch.stack([det, udet, vdet, sdet]),
                    torch.zeros((4, padded.shape[0] - 300, 16))], dim=1)
    rng = np.random.default_rng(32)
    m = 512
    o = rng.uniform(-6, 6, (m, 3)).astype(np.float32)
    d = rng.normal(size=(m, 3)).astype(np.float32)
    d[::5] = np.eye(3, dtype=np.float32)[rng.integers(0, 3, len(d[::5]))] * \
        rng.choice([-1.0, 1.0], (len(d[::5]), 1)).astype(np.float32)
    d[::11] = 0.0
    o[::13, rng.integers(0, 3)] = 0.0
    o3 = tuple(torch.from_numpy(np.ascontiguousarray(o[:, k])) for k in range(3))
    d3 = tuple(torch.from_numpy(np.ascontiguousarray(d[:, k])) for k in range(3))
    ref = I.mt_products(w4, o3, d3)
    got = K.record_products([padded[None, :, k] for k in range(16)],
                            [c[:, None] for c in o3], [c[:, None] for c in d3])
    for name, a, b in zip(("det", "udet", "vdet", "sdet"), got, ref):
        assert torch.equal(a, b), name
    assert (ref[0].abs() >= BIAS).float().mean() > 0.5


# the pairs at the edges of each reject: (det, udet, vdet, sdet) per pair,
# as multiples of det where the quantity is a ratio's numerator
_BIAS_DOWN = float(np.nextafter(np.float32(BIAS), np.float32(0)))
_BIAS_UP = float(np.nextafter(np.float32(BIAS), np.float32(1)))
_TINY = float(np.float32(1e-40))               # a denormal
_NAN = float("nan")


def _edges(reject):
    """(det, udet, vdet, sdet) float32 [P] each for pairs at the edges of
    `reject`; the other quantities sit inside the window (u = v = 0.25,
    s = 1)."""
    if reject == "det":
        rows = [(det, 0.25 * det, 0.25 * det, det)
                for det in (BIAS, -BIAS, _BIAS_DOWN, -_BIAS_DOWN, _BIAS_UP, -_BIAS_UP, 0.0,
                            -0.0, _TINY, -_TINY, 1.0, -1.0, _NAN)]
    else:
        # the varied quantity as a multiple of det (a ratio u, v or s at an
        # edge) or as itself (zeros, denormals, NaN)
        ratios = [BIAS, -BIAS, _BIAS_DOWN, -_BIAS_DOWN, _BIAS_UP, 2.0 * BIAS, 0.25, 0.5, 1.0,
                  float(np.nextafter(np.float32(1), np.float32(2))), -1.0]
        values = [0.0, -0.0, _TINY, -_TINY, _NAN]
        which = {"udet": 1, "vdet": 2, "sdet": 3}[reject]
        rows = []
        for det in (1.0, -1.0, 3.0, -0.75, BIAS, -BIAS, 2.0 * BIAS, -2.0 * BIAS):
            for x in [r * det for r in ratios] + values:
                row = [det, 0.25 * det, 0.25 * det, det]
                row[which] = x
                rows.append(tuple(row))
    a = np.asarray(rows, np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a[:, k])) for k in range(4))


def _window(det, udet, vdet, sdet, max_len, edge, any_hit):
    """The accept window of the plain versions (closest_plain, any_plain)."""
    inv = 1.0 / det
    u, v, s = udet * inv, vdet * inv, sdet * inv
    lo = BIAS if any_hit else edge
    ok = det >= BIAS if any_hit else det.abs() >= BIAS
    ok = ok & (u >= lo) & (u <= 1.0) & (v >= lo) & (u + v <= 1.0)
    return ok & (s > BIAS) & (s <= max_len)


def _rejects(det, udet, vdet, sdet, edge, any_hit):
    """The kernels' early rejects (csrc/sparse.cu fl_rec_closest,
    fl_rec_any), each as the pairs it rejects."""
    if any_hit:
        return {"det": ~(det >= BIAS), "sdet": ~(sdet > 0.0), "udet": ~(udet > 0.0),
                "vdet": ~(vdet > 0.0)}
    pos = det > 0.0

    def other_sign(x):                          # zero, the other sign than det, or NaN
        return ~torch.where(pos, x > 0.0, x < 0.0)

    out = {"det": ~(det.abs() >= BIAS), "sdet": other_sign(sdet)}
    if edge > 0.0:                              # bounce casts: u, v >= BIAS > 0
        out.update(udet=other_sign(udet), vdet=other_sign(vdet))
    return out


def _pair_records(det, udet, vdet, sdet):
    """[P, 128, 16] tiles whose first record meets the ray o = 0, d = +z in
    exactly (det, udet, vdet, sdet): with those features every other term
    is an exact zero. The rest of each tile is zero padding."""
    p = det.shape[0]
    rec = torch.zeros((p, S.TRI_TILE, 16))
    rec[:, 0, 2] = -det
    rec[:, 0, 3] = -sdet
    rec[:, 0, 6] = -udet
    rec[:, 0, 9] = -vdet
    return rec


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler for the emulated kernel build")
    return _native.build_library(tmp_path_factory.mktemp("kernels"), emulate=True)


@pytest.mark.parametrize("reject", ["det", "sdet", "udet", "vdet"])
def test_early_rejects_take_only_what_the_window_rejects(lib, reject):
    quad = _edges(reject)
    p = quad[0].shape[0]
    rec = _pair_records(*quad)
    # one ray per ray tile (ray_tile 1), whose worklist is its pair's tile
    o3 = tuple(torch.zeros(p) for _ in range(3))
    d3 = (torch.zeros(p), torch.zeros(p), torch.ones(p))
    iota = torch.arange(p, dtype=torch.int32)
    tlist = ((iota[:, None] + iota[None]) % p).contiguous()
    tms = torch.full((p, p), POW32)
    tms[:, 0] = 0.0
    counts = torch.ones(p, dtype=torch.int32)
    got = K.record_products([rec[:, 0, k] for k in range(16)], o3, d3)
    for a, b in zip(got, quad):
        assert torch.equal(a.isnan(), b.isnan()) and torch.equal(a[~a.isnan()], b[~b.isnan()])
    fired = False
    for edge, any_hit, max_len in ((-BIAS, False, POW32), (BIAS, False, POW32),
                                   (BIAS, True, 1.5)):
        ml = torch.full((p,), max_len)
        accept = _window(*quad, ml, edge, any_hit)
        rejects = _rejects(*quad, edge, any_hit)
        if reject in rejects:
            taken = rejects[reject]
            assert not (taken & accept).any(), (edge, any_hit, torch.nonzero(taken & accept))
            fired |= bool(taken.any())
        if any_hit:
            hit = K._any_launch(lib, 0, rec, tlist, counts, o3, d3, ml, 1)
            assert torch.equal(hit, K.any_plain(rec, tlist, counts, o3, d3, ml, 1))
            assert torch.equal(hit, accept)
        else:
            out = K._closest_launch(lib, 0, rec, tlist, tms, counts, o3, d3, ml, edge, 1)
            ref = K.closest_plain(rec, tlist, tms, counts, o3, d3, ml, edge, 1)
            assert all(torch.equal(a, b) for a, b in zip(out, ref))
            assert torch.equal(out[3] >= 0, accept)
        assert accept.any() and not accept.all()
    assert fired


def test_python_copies_of_the_cast_constants_match_sparse_cu():
    """CAST_LANES (the casts' ray-tile limit, chip_smoke.py's lane-tests)
    copies FL_SUB_LANES of the card build, RING (the worklist lengths the
    walk tests need) FL_RING."""
    src = (_native.CSRC / "sparse.cu").read_text()
    card = re.search(r"#ifdef FL_EMULATE\n#define FL_SUB_LANES 1\n#else\n"
                     r"#define FL_SUB_LANES (\d+)\n#endif", src)
    ring = re.search(r"^#define FL_RING (\d+)", src, re.M)
    assert card and ring
    assert K.CAST_LANES == int(card.group(1)) and RING == int(ring.group(1))
    assert K.CAST_LANES * 128 <= K.MAX_RAY_TILE
