"""The traversal kernels of scheme="kernel" (csrc/intersect.cu: closest hit
and any hit over the 16-float triangle record with exact early rejects,
staged from W in chunks of CAST_CHUNK triangles), compiled for the host
(-DFL_EMULATE: every ray in turn is a block of one), against their plain
versions, which keep W's 64-term products (ops/intersect_kernel.py
closest_hit_plain / any_hit_plain).

The record's products equal W's but for a zero's sign, so the crafted
cases of tests/test_torch_fused_record.py put (ray, triangle) pairs on each
reject's edge: on the bounce casts (the shadow any hit along +z and the
next closest hit along -z, whose u / v edge is BIAS) and on the primary
cast (the relaxed -BIAS edge, where u = 0 is accepted and its zero's sign
reaches the output). Each case's triangles sit among far-off fillers at
the end of W of T = 1, 20, one chunk, one chunk + 1 (two triangles then
straddle the chunks' boundary) and three chunks + 5 triangles, so that
they are staged in the first, the second and the fourth chunk; the rays
beside them are dead (max_len 0 or NaN) or have a zero direction (cast
as +z). `walk_casts` gives rays that each hit one triangle of a W of
three chunks + 5 (the any hits leave at different triangles, a back face
makes one search the whole list, a duplicate triangle makes a tie). The
outputs must be identical (==, NaN equal to NaN, a zero equal to a zero
of either sign). The `gpu` twins of these cases are in
tests/test_torch_cuda.py."""

import re
import shutil

import numpy as np
import pytest
import torch

from flexlight_tpu_torch import _native
from flexlight_tpu_torch.ops import intersect_kernel as IK
from flexlight_tpu_torch.ops.intersect import BIAS, POW32
# by the name pytest collects it under (its rootdir insertion puts tests/
# on the path)
from test_torch_fused_record import (FRAME_EDGES, POST_EDGES, check_frame_edge, check_post_edge,
                                     frame_edge_args, identical, post_edge_args)

CAST_CHUNK = 256     # csrc/intersect.cu FL_CAST_CHUNK: triangles a block stages at once
SIZES = (1, 20, CAST_CHUNK, CAST_CHUNK + 1, 3 * CAST_CHUNK + 5)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler for the emulated kernel build")
    return _native.build_library(tmp_path_factory.mktemp("kernels"), emulate=True)


def _fillers(n, seed, device):
    """W [4, n, 16] of n triangles of random orientation in x, y in [20, 60]:
    no ray of these tests (|x|, |y| < 1) meets one."""
    rng = np.random.default_rng(seed)
    c = rng.uniform([20, 20, -5], [60, 60, 5], (n, 1, 3))
    tris = (c + rng.uniform(-2, 2, (n, 3, 3))).reshape(n, 9).astype(np.float32)
    return IK.build_w4(torch.from_numpy(tris).to(device),
                       torch.arange(n, dtype=torch.int32, device=device))[0]


def padded(w4c, idsc, t_total, seed=0):
    """W of max(t_total, Tc) triangles: the Tc columns of w4c last, far-off
    fillers (ids 1000, 1001, ...) before them; (w4, ids)."""
    dev = w4c.device
    n = max(t_total - w4c.shape[1], 0)
    w4 = torch.cat([_fillers(n, seed, dev), w4c], dim=1).contiguous()
    ids = torch.cat([torch.arange(1000, 1000 + n, dtype=torch.int32, device=dev), idsc])
    return w4, ids


def _rays(o, d, max_len):
    """8 rays: 5 copies of (o, d, max_len), then a dead one (max_len 0), one
    with max_len NaN and one with a zero direction (cast as +z)."""
    dev = o.device
    n = 8
    o3 = tuple(o[k].expand(n).contiguous() for k in range(3))
    d3 = [d[k].expand(n).clone() for k in range(3)]
    for k in range(3):
        d3[k][7] = 0.0
    ml = torch.full((n,), float(max_len), dtype=torch.float32, device=dev)
    ml[5] = 0.0
    ml[6] = float("nan")
    return o3, tuple(d3), ml


def bounce_edge_casts(name, t_total, device="cpu"):
    """POST_EDGES' case `name` as the traversal kernels' inputs: W (the
    case's triangles last among fillers), the shadow any hit's rays along
    +z (max_len 2) and the next closest hit's along -z (edge BIAS)."""
    args, (o, d_shadow, d_next) = post_edge_args(name, device)
    check_post_edge(name, args, (o, d_shadow, d_next))
    w4, ids = padded(args[3], args[4], t_total)
    return w4, ids, _rays(o, d_shadow, 2.0), _rays(o, d_next, POW32)


def primary_edge_casts(name, t_total, device="cpu"):
    """FRAME_EDGES' case `name`: W and the primary closest hit's rays from
    the camera along +z (edge -BIAS)."""
    args = frame_edge_args(name, device)
    check_frame_edge(name, args)
    w4, ids = padded(args[2], args[3], t_total)
    return w4, ids, _rays(args[10], args[0][:, 0], POW32)


def walk_casts(device="cpu"):
    """W of 3 chunks + 5 triangles, triangle k a small one facing -z (a
    +z ray meets its front) at x = 2k, z = 1 + k / 1000; the last a
    duplicate of triangle 700. Odd k are back faces (wound the other way).
    Rays along +z from (2 t_i + 0.2, 0.2, 0) aim at t_i = 97 i mod T, so
    within each block of rays the any hits leave at triangles of every
    chunk; every 13th ray is dead and every 17th has max_len 0.5 (short of
    every triangle). (w4, ids, o3, d3, closest max_len, any max_len)."""
    t = 3 * CAST_CHUNK + 5
    k = np.arange(t, dtype=np.float64)
    x0, z = 2.0 * k, 1.0 + k / 1000.0
    v0 = np.stack([x0, np.zeros(t), z], -1)
    v1 = v0 + [0.0, 1.0, 0.0]
    v2 = v0 + [1.0, 0.0, 0.0]
    back = (np.arange(t) % 2) == 1
    v1[back], v2[back] = v2[back].copy(), v1[back].copy()
    tris = np.concatenate([v0, v1, v2], -1)
    tris[-1] = tris[700]
    w4, ids = IK.build_w4(torch.from_numpy(tris.astype(np.float32)).to(device),
                          torch.arange(t, dtype=torch.int32, device=device))
    n = 1100
    aim = (97 * np.arange(n)) % t
    aim[5] = 700                     # the duplicate: a tie, the lowest column wins
    o = np.stack([2.0 * aim + 0.2, np.full(n, 0.2), np.zeros(n)]).astype(np.float32)
    d = np.zeros((3, n), np.float32)
    d[2] = 1.0
    d[:, 3] = 0.0                    # a zero direction: cast as +z
    ml = np.full(n, 10.0, np.float32)
    ml[::13] = 0.0
    short = ml.copy()
    short[::17] = 0.5
    as_t = lambda a: tuple(torch.from_numpy(np.ascontiguousarray(c)).to(device) for c in a)
    return (w4, ids, as_t(o), as_t(d), torch.from_numpy(ml).to(device),
            torch.from_numpy(short).to(device))


def _check_closest(launch, w4, ids, rays, edge):
    o3, d3, ml = rays
    got = launch(w4, ids, o3, d3, ml, edge)
    ref = IK.closest_hit_plain(w4, ids, o3, d3, ml, edge)
    assert all(identical(a, b) for a, b in zip(got, ref))
    return ref


def _check_any(launch, w4, rays):
    o3, d3, ml = rays
    got = launch(w4, o3, d3, ml)
    ref = IK.any_hit_plain(w4, o3, d3, ml)
    assert torch.equal(got, ref)
    return ref


def test_chunk_copies_intersect_cu():
    src = (_native.CSRC / "intersect.cu").read_text()
    m = re.search(r"^#define FL_CAST_CHUNK (\d+)", src, re.M)
    assert m and CAST_CHUNK == int(m.group(1))


@pytest.mark.parametrize("t_total", SIZES)
@pytest.mark.parametrize("name", sorted(POST_EDGES))
def test_bounce_casts_are_exact_on_the_reject_edges(lib, name, t_total):
    w4, ids, shadow, nxt = bounce_edge_casts(name, t_total)
    closest = lambda *a: IK._closest_hit_launch(lib, 0, *a)  # noqa: E731
    anyhit = lambda *a: IK._any_hit_launch(lib, 0, *a)  # noqa: E731
    hit = _check_any(anyhit, w4, shadow)
    ref = _check_closest(closest, w4, ids, nxt, BIAS)
    expect_any, expect_closest = POST_EDGES[name][-1]
    assert hit[:5].eq(expect_any).all() and not hit[5:7].any()
    assert (ref[3][:5] >= 0).eq(expect_closest).all() and (ref[3][5:7] == -1).all()


@pytest.mark.parametrize("t_total", SIZES)
@pytest.mark.parametrize("name", sorted(FRAME_EDGES))
def test_primary_casts_are_exact_on_the_reject_edges(lib, name, t_total):
    w4, ids, rays = primary_edge_casts(name, t_total)
    ref = _check_closest(lambda *a: IK._closest_hit_launch(lib, 0, *a), w4, ids, rays, -BIAS)
    assert (ref[3][:5] >= 0).eq(FRAME_EDGES[name][-1]).all() and (ref[3][5:7] == -1).all()


def test_the_walk_is_exact_across_chunks(lib):
    """Closest hits (both edges) and any hits of rays that each meet one
    triangle of a 3-chunk W: hits in every chunk, the tie to the lower
    column, the back faces (no any hit, a closest hit), dead, short and
    zero-direction rays."""
    w4, ids, o3, d3, ml, short = walk_casts()
    closest = lambda *a: IK._closest_hit_launch(lib, 0, *a)  # noqa: E731
    for edge in (BIAS, -BIAS):
        ref = _check_closest(closest, w4, ids, (o3, d3, ml), edge)
    tri = ref[3]
    assert int(tri[5]) == 700
    assert set((tri[tri >= 0] // CAST_CHUNK).tolist()) == {0, 1, 2, 3}
    assert bool((tri[ml == 0] == -1).all())
    hit = _check_any(lambda *a: IK._any_hit_launch(lib, 0, *a), w4, (o3, d3, short))
    assert hit.any() and not hit.all()
    assert not bool(hit[short <= 0.5].any())
