"""The slab test of the worklist prepass (csrc/sparse.cu: the tile flags
`fl_sparse_flags_kernel` and the nearest2 key `fl_sparse_key_kernel`),
built for the host (-DFL_EMULATE), against their plain versions
`flags_plain` / `nearest2_key_plain` (pinned to flexlight_tpu's
`_tmins_xla` / `_nearest2_key_xla` in tests/test_torch_sparse.py).

Both kernels must be identical to the plain versions (torch.equal) on the
inputs where a faster slab test or a cull could go wrong (`slab_cases`):
denormal direction components (1 / d = +-inf), zero ones (1 / d = 1e30,
through `_prep_soa`), cluster boxes of +-inf padding, origins on a box face
(0 x inf = NaN) and inside several boxes (entry = BIAS ties in the key),
a ray tile whose 1 / d spans both signs, a ray tile with one live ray,
dead rays beside live ones, and a key over more boxes than one shared
chunk. `corner_case` holds the flags' interval cull to its exact edges:
in each of its ray tiles the only flagging ray sits at the corner of the
tile's span, so a cull one ulp too eager changes the flags.

The emulated block is one lane: its warp votes and reductions are the
lane's own. tests/test_torch_cuda.py runs `slab_cases` and `corner_case`
through both kernels on the card."""

import importlib.util
import re
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from flexlight_tpu_torch import _native
from flexlight_tpu_torch.ops import intersect_sparse as S
from flexlight_tpu_torch.ops import intersect_sparse_kernel as K
from flexlight_tpu_torch.ops.intersect import BIAS, POW32

RT = 128                 # rays of a ray tile
SMOKE = Path(__file__).resolve().parent.parent / "chip_smoke.py"
DENORMAL = np.float32(1e-40)


def _t3(a, device="cpu"):
    return tuple(torch.from_numpy(np.ascontiguousarray(a[:, c])).to(device) for c in range(3))


def _boxes(rng, k, spread=6.0):
    c = rng.uniform(-spread, spread, (k, 3)).astype(np.float32)
    h = rng.uniform(0.3, 2.5, (k, 3)).astype(np.float32)
    return c - h, c + h


def _rays(rng, n, spread=8.0):
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d, np.full(n, POW32, np.float32)


def slab_cases(seed=0):
    """{name: (box_min, box_max [K, 3], o, d [N, 3], max_len [N])} as
    numpy float32, K even and N whole ray tiles of RT."""
    rng = np.random.default_rng(seed)
    cases = {}

    lo, hi = _boxes(rng, 24)
    o, d, ml = _rays(rng, 2 * RT)
    d[::3, 0] = DENORMAL
    d[1::5, 1] = -DENORMAL
    d[2::7] = [DENORMAL, -DENORMAL, 1.0]
    o[::4, 0] = lo[5, 0]                  # on a face, beside a denormal component: 0 x inf
    o[1::6, 1] = hi[7, 1]
    # box 9 flat in z, and rays from inside its x, y extent on its plane
    # with a denormal d.z: both of that axis's t are 0 x inf = NaN, so
    # they enter nothing (a NaN-ignoring min / max would drop the axis)
    hi[9, 2] = lo[9, 2]
    o[3::16] = (lo[9] + hi[9]) / 2
    d[3::16] = [0.6, 0.8, DENORMAL]
    ml[::9] = 0.0
    cases["denormal"] = (lo, hi, o, d, ml)

    lo, hi = _boxes(rng, 24)
    o, d, ml = _rays(rng, 2 * RT)
    d[::2, 0] = 0.0
    d[1::3, 1] = -0.0
    d[::5, 2] = 0.0
    d[::11] = 0.0                          # a zero direction: +z after _prep_soa
    o[::4, 0] = lo[3, 0]                  # on a face, beside a zero component: 0 x 1e30
    cases["zero"] = (lo, hi, o, d, ml)

    lo, hi = _boxes(rng, 20)
    lo[-4:], hi[-4:] = np.inf, -np.inf    # two triangle tiles of padding (build_tiled)
    o, d, ml = _rays(rng, RT)
    ml[::3] = 0.0
    cases["padding"] = (lo, hi, o, d, ml)

    # nested boxes around the origin (entry = BIAS in each), and origins on
    # their faces
    lo, hi = _boxes(rng, 16, spread=1.0)
    s = np.linspace(0.5, 4.0, 8, dtype=np.float32)[:, None]
    lo[:8], hi[:8] = -s, s
    o = np.zeros((2 * RT, 3), np.float32)
    o[RT:] = rng.uniform(-0.4, 0.4, (RT, 3))
    o[RT::3, 0] = -0.5                    # on a face of box 0
    o[RT + 1::3, 1] = 1.0
    d = rng.normal(size=(2 * RT, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[RT::4, 0] = 0.0
    cases["faces"] = (lo, hi, o, d, np.full(2 * RT, POW32, np.float32))

    # one origin, a fan of directions across d.x = 0 (1 / d.x from -inf
    # through -1e30 and 1e30 to +inf), and lengths that end inside boxes
    lo, hi = _boxes(rng, 32)
    o = np.tile(np.float32([0.2, -0.3, -12.0]), (RT, 1))
    dx = np.linspace(-0.3, 0.3, RT).astype(np.float32)
    dx[60:68] = [-1e-20, -DENORMAL, -0.0, 0.0, DENORMAL, 1e-20, 1e-30, -1e-30]
    d = np.stack([dx, np.full(RT, 0.05, np.float32), np.ones(RT, np.float32)], axis=1)
    ml = rng.uniform(4.0, 20.0, RT).astype(np.float32)
    cases["both_signs"] = (lo, hi, o, d, ml)

    # ray tile 0: one live ray; tile 1: its first 64 rays dead (a dead warp
    # of the key), the rest live; tile 2: all dead
    lo, hi = _boxes(rng, 20)
    o, d, ml = _rays(rng, 3 * RT)
    ml[:RT] = 0.0
    ml[77] = POW32
    ml[RT:RT + 64] = 0.0
    ml[RT + 64:2 * RT:2] = rng.uniform(0.5, 9.0, 32)
    ml[2 * RT:] = 0.0
    cases["sparse_live"] = (lo, hi, o, d, ml)

    # more boxes than one of the key's shared chunks (256), and than one
    # of the flags' (1024)
    lo, hi = _boxes(rng, 1030, spread=10.0)
    o, d, ml = _rays(rng, RT)
    ml[::4] = 0.0
    cases["many_boxes"] = (lo, hi, o, d, ml)
    return cases


def corner_case():
    """(box_min, box_max [4, 3], o, d [3 * RT, 3], max_len) whose ray tiles
    each have one flagging ray at the corner of the tile's span, so that
    the cull's bound meets that ray's value. Every ray starts at
    (-1, 0, z) with 1 / d = (1, 1, 1e30): within a tile only o.z differs,
    so the span's x and y corners are each ray's own values, and a box
    constrains o.z only to its z range (tiles 0 and 1: z in [0.25, 0.75];
    tile 2: [1.6, 1.9]). The first ray of a tile is the only one that
    may flag the clusters below; the others end at 2.
    - tile 0, cluster 0 ([0, 1] x [2, 3] x [0, 2]): met on its edge, tmin =
      tmax = entry = 2, so tmax_hi = entry_lo = 2;
    - tile 1, cluster 2 ([1, 2] x [1, 3] x [0, 1]): entry 2, tmax 3; the
      first ray ends at the least float above 2, so tmin_lo = 2 lies one
      ulp below the longest length;
    - tile 2, cluster 1 ([1 - 2^-23, 3] x [0.5, 5] x [1.5, 2], beside
      cluster 0 in triangle tile 0): every ray enters it at 2 - 2^-23, one
      ulp below cluster 0's minimum 2, so the second cluster must be tested.
    Flags: [[2, 2], [2, 2], [2 - 2^-23, POW32]]."""
    eps = 2.0 ** -23
    lo = np.float32([[0, 2, 0], [1 - eps, 0.5, 1.5], [1, 1, 0], [5, 5, 5]])
    hi = np.float32([[1, 3, 2], [3, 5, 2], [2, 3, 1], [6, 6, 6]])
    o = np.zeros((3 * RT, 3), np.float32)
    o[:, 0] = -1.0
    o[:2 * RT, 2] = np.tile(np.linspace(0.25, 0.75, RT, dtype=np.float32), 2)
    o[2 * RT:, 2] = np.linspace(1.6, 1.9, RT, dtype=np.float32)
    d = np.tile(np.float32([1.0, 1.0, 0.0]), (3 * RT, 1))
    ml = np.full(3 * RT, 2.0, np.float32)
    ml[0] = ml[2 * RT] = POW32
    ml[RT] = np.nextafter(np.float32(2.0), np.float32(3.0))
    return lo, hi, o, d, ml


def flags_inputs(case, device="cpu"):
    lo, hi, o, d, ml = case
    o3, d3, mlp, _ = S._prep_soa(_t3(o, device), _t3(d, device),
                                 torch.from_numpy(ml).to(device), RT)
    return torch.from_numpy(lo).to(device), torch.from_numpy(hi).to(device), o3, d3, mlp


def key_inputs(case, device="cpu"):
    lo, hi, o, d, ml = case
    return (torch.from_numpy(lo).to(device), torch.from_numpy(hi).to(device), _t3(o, device),
            _t3(d, device), torch.from_numpy(ml).to(device))


needs_cxx = pytest.mark.skipif(shutil.which("g++") is None and shutil.which("c++") is None,
                               reason="no host C++ compiler for the emulated kernel build")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return _native.build_library(tmp_path_factory.mktemp("kernels"), emulate=True)


CASES = ("denormal", "zero", "padding", "faces", "both_signs", "sparse_live", "many_boxes")


@needs_cxx
@pytest.mark.parametrize("name", CASES)
def test_flags_kernel_is_identical_to_plain(lib, name):
    args = flags_inputs(slab_cases()[name])
    ref = K.flags_plain(*args, RT)
    assert torch.equal(K._flags_launch(lib, 0, *args, RT), ref)
    assert (ref < POW32).any()


@needs_cxx
@pytest.mark.parametrize("name", CASES)
def test_key_kernel_is_identical_to_plain(lib, name):
    args = key_inputs(slab_cases()[name])
    ref = K.nearest2_key_plain(*args)
    assert torch.equal(K._key_launch(lib, 0, *args), ref)
    live = args[4] > 0
    assert (ref[~live] == K.DEAD_KEY).all() and (ref[live] < K.DEAD_KEY).all()


def test_cases_reach_the_edges():
    """The cases hold what their names say: NaN and infinite t values, the
    padding flagged at BIAS (an inverted box constrains no axis), entry =
    BIAS ties among the nested boxes, 1 / d of both signs in one tile."""
    cases = slab_cases()
    lo, hi, o3, d3, ml = flags_inputs(cases["denormal"])
    inv = K._inv_dir(torch.stack(d3, -1))
    tmin, tmax = K._slab(lo, hi, torch.stack(o3, -1), inv)
    assert torch.isinf(inv).any() and torch.isnan(tmin).any()
    assert torch.isnan(tmin[3::16, 9]).all()
    lo, hi, o3, d3, ml = flags_inputs(cases["zero"])
    assert (K._inv_dir(torch.stack(d3, -1)) == 1e30).any()
    flags = K.flags_plain(*flags_inputs(cases["padding"]), RT)
    assert (flags[:, -2:] == BIAS).all()
    lo, hi, o3, d3, ml = flags_inputs(cases["faces"])
    tmin, tmax = K._slab(lo, hi, torch.stack(o3, -1), K._inv_dir(torch.stack(d3, -1)))
    entry = torch.maximum(tmin, torch.tensor(BIAS))
    assert ((entry == BIAS) & (tmax >= entry)).sum(dim=1).max() >= 8
    inv = K._inv_dir(torch.stack(flags_inputs(cases["both_signs"])[3], -1))[:, 0]
    assert (inv < 0).any() and (inv > 0).any()
    assert torch.isinf(inv).sum() == 2 and (inv.abs() == 1e30).sum() >= 2


def flags_cull():
    """chip_smoke.py's mirror of the kernel's cull, which its flags bound
    counts by."""
    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.flags_cull


def test_cull_is_exact_on_the_corner_case():
    """The mirror of the kernel's cull (`flags_cull`) culls no cluster that
    a ray of the tile flags, and on `corner_case` its bounds meet the
    flagging rays' values exactly."""
    cull = flags_cull()
    args = flags_inputs(corner_case())
    none, entry_lo, live = cull(*args, RT)
    flags = K.flags_plain(*args, RT)
    below = float(np.float32(2.0 - 2.0 ** -23))
    assert live.all()
    assert flags.tolist() == [[2.0, 2.0], [2.0, 2.0], [below, POW32]]
    tmin, tmax = K._slab(args[0], args[1], torch.stack(args[2], -1),
                         K._inv_dir(torch.stack(args[3], -1)))
    assert float(tmin[0, 0]) == float(tmax[0, 0]) == 2.0       # on the edge
    assert not none[0, 0] and float(entry_lo[0, 0]) == 2.0
    assert not none[1, 2] and float(entry_lo[1, 2]) == 2.0
    assert not none[2, 1] and float(entry_lo[2, 1]) == below
    for name, case in list(slab_cases().items()) + [("corner", corner_case())]:
        a = flags_inputs(case)
        none, entry_lo, _ = cull(*a, RT)
        least = K.cluster_minima_plain(*a, RT)
        assert not (none & (least < POW32)).any(), name
        assert not ((entry_lo > least) & (least < POW32)).any(), name


@needs_cxx
def test_flags_kernel_on_the_corner_case(lib):
    args = flags_inputs(corner_case())
    assert torch.equal(K._flags_launch(lib, 0, *args, RT), K.flags_plain(*args, RT))


@needs_cxx
def test_flags_kernel_takes_at_most_one_warp_of_rays(lib):
    args = flags_inputs(slab_cases()["padding"])
    o3, d3 = (tuple(torch.cat([c, c]) for c in x) for x in args[2:4])
    with pytest.raises(ValueError):
        K._flags_launch(lib, 0, args[0], args[1], o3, d3, torch.cat([args[4]] * 2), 2 * RT)


def test_python_copies_agree_with_the_source():
    """ops.intersect_sparse_kernel's FLAGS_RAY_TILE is sparse.cu's
    FL_FLAGS_RAY_TILE, and chip_smoke.py's KEY_RAYS / KEY_BLOCK_RAYS (which
    count the key's working warps) are its FL_KEY_RAYS and a block's rays."""
    src = (_native.CSRC / "sparse.cu").read_text()

    def define(name):
        return int(re.search(rf"^#define {name} (\d+)", src, re.M).group(1))

    assert K.FLAGS_RAY_TILE == define("FL_FLAGS_RAY_TILE")
    smoke = SMOKE.read_text()
    m = re.search(r"^KEY_RAYS, KEY_BLOCK_RAYS = (\d+), (\d+)", smoke, re.M)
    assert (int(m.group(1)), int(m.group(2))) == (
        define("FL_KEY_RAYS"), define("FL_KEY_RAYS") * define("FL_KEY_THREADS"))
