"""PRE, POST over its live-ray list and the whole-frame kernel with lane
refill (csrc/fused.cu), compiled for the host (-DFL_EMULATE: one block of
one thread takes every ray, or the whole list, in turn), against their
plain versions, which keep W's 64-term products (ops/fused.py
sp_pre_plain, sp_post_plain, fused_frame_plain).

The kernels test the 16-float triangle record with exact early rejects
(csrc/trace.cuh), which they build from W in shared memory; the record's
products equal W's wherever W's zero products meet finite ray features,
but a zero may come out with the other sign. So the crafted cases put
(ray, triangle) pairs on each reject's edge, on the bounce casts (POST:
the shadow any hit and the next closest hit, whose u / v edge is BIAS)
and on the primary cast (FRAME and PRE: the relaxed -BIAS edge, where u =
0 is accepted and its zero's sign reaches the output; PRE's with the
crafted triangle alone and last among 19 far-off ones): |det| = BIAS and just
below, sdet = 0, udet = 0, vdet = 0, u on the window's edge and just past
it, a back face. The outputs must be identical (==, NaN equal to NaN; a
zero equals a zero of either sign, as everywhere the kernels are held).
The other cases: a bounce where every ray is dead, rays dying at each
bounce, spp 2, both RNG modes, and a scene at the 1024-triangle cap (a
64 KB record table: PRE, every POST call and FRAME); the list lists each live ray once; FRAME's lane
counts (`lane_stats`) count every live ray-bounce once.

As in tests/test_torch_kernels_emulated.py, the plain versions take a
correctly rounded sqrt (`exact_sqrt`) and, under rng="hash", the C
library's sinf (`host_sin`), which the emulated kernels call. The `gpu`
twins of these cases are in tests/test_torch_cuda.py."""

import ctypes
import ctypes.util
import shutil

import numpy as np
import pytest
import torch

import flexlight_tpu_torch as port
from flexlight_tpu_torch import Config, _native, reset_global_registry
from flexlight_tpu_torch.kernels import PLAIN
from flexlight_tpu_torch.models.pathtracer import PathTracer
from flexlight_tpu_torch.ops import fused as F
from flexlight_tpu_torch.ops import fused_kernel as SK
from flexlight_tpu_torch.ops import rng
from flexlight_tpu_torch.ops import vec3 as v3
from flexlight_tpu_torch.ops.buffers import build_scene_buffers
from flexlight_tpu_torch.ops.geometry import world_geometry
from flexlight_tpu_torch.ops.intersect import BIAS, POW32
from flexlight_tpu_torch.ops.intersect_kernel import any_hit_plain, closest_hit_plain
from flexlight_tpu_torch.ops.intersect_sparse import tri_record
from flexlight_tpu_torch.ops.intersect_sparse_kernel import record_products
from flexlight_tpu_torch.ops.pathtrace import sample_cos
from flexlight_tpu_torch.scenes import stand_in_wood_texture, theater, wave

needs_cxx = pytest.mark.skipif(shutil.which("g++") is None and shutil.which("c++") is None,
                               reason="no host C++ compiler for the emulated kernel build")

FINE, COARSE = 2.0 ** -2, 2.0 ** -8   # triangle legs: COARSE * COARSE = BIAS
RAYS = 8                              # rays of a crafted case

# POST's crafted cases: (leg a along +y, leg b along +x, the ray's y, the
# triangles' x, flipped winding) and the outcome of (shadow cast, next
# closest hit). The ray leaves (0, y, 0): its shadow ray toward the light at
# (0, y, 2) along +z (max_len 2), its next ray along -z (a mirror bounce).
# One triangle at z = 1 and one at z = -1 (sdet_zero: one at z = 0, in the
# origin's plane); u = y / a and v = -x / b on both, s = 1.
POST_EDGES = {
    "det_bias": (COARSE, COARSE, COARSE / 4, -COARSE / 4, False, (True, True)),
    "det_below_bias": (COARSE, COARSE * (1 - 2.0 ** -23), COARSE / 4, -COARSE / 4, False,
                       (False, False)),
    "sdet_zero": (FINE, FINE, FINE / 4, -FINE / 4, False, (False, False)),
    "udet_zero": (FINE, FINE, 0.0, -FINE / 4, False, (False, False)),
    "vdet_zero": (FINE, FINE, FINE / 4, 0.0, False, (False, False)),
    "u_on_edge": (FINE, FINE, FINE * BIAS, -FINE / 4, False, (True, True)),
    "u_below_edge": (FINE, FINE, FINE * BIAS * (1 - 2.0 ** -21), -FINE / 4, False,
                     (False, False)),
    "back_face": (FINE, FINE, FINE / 4, -FINE / 4, True, (False, True)),
}
# FRAME's crafted primaries: (a, b, the camera's y, the triangle's x,
# flipped, hit): the camera at (0, y, 0) looks along +z at one triangle at
# z = 1 (z = 0, the camera's plane, for sdet_zero); u = y / a, v = -x / b.
FRAME_EDGES = {
    "u_zero": (FINE, FINE, 0.0, -FINE / 4, False, True),
    "u_on_edge": (FINE, FINE, -FINE * BIAS, -FINE / 4, False, True),
    "u_past_edge": (FINE, FINE, -FINE * BIAS * (1 + 2.0 ** -20), -FINE / 4, False, False),
    "det_minus_bias": (COARSE, COARSE, COARSE / 4, -COARSE / 4, True, True),
    "sdet_zero": (FINE, FINE, FINE / 4, -FINE / 4, False, False),
    "v_zero": (FINE, FINE, FINE / 4, 0.0, False, True),
}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler for the emulated kernel build")
    return _native.build_library(tmp_path_factory.mktemp("kernels"), emulate=True)


@pytest.fixture
def exact_sqrt(monkeypatch):
    monkeypatch.setattr(v3, "sqrt", lambda x: torch.sqrt(x.double()).to(torch.float32))


@pytest.fixture
def host_sin(monkeypatch):
    sinf = ctypes.CDLL(ctypes.util.find_library("m")).sinf
    sinf.restype, sinf.argtypes = ctypes.c_float, [ctypes.c_float]
    monkeypatch.setattr(rng, "_sin", lambda x: torch.tensor(
        [sinf(float(a)) for a in x.reshape(-1).tolist()], dtype=torch.float32).reshape(x.shape))


def identical(a, b) -> bool:
    """Equal values (NaN equal to NaN), the kernels' standard."""
    return a.shape == b.shape and bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def _clone(args):
    return tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)


def _triangle_scene(tris, device):
    """SceneBuffers of triangles v0 = (x, 0, z), v1 = v0 + (0, a, 0), v2 =
    v0 + (b, 0, 0) (v1 and v2 swapped where flipped), each (a, b, x, z,
    flipped), and the engine's camera."""
    reset_global_registry()
    e = port.FlexLight((16, 16), device=device)
    for a, b, x, z, flip in tris:
        v0, v1, v2 = [x, 0.0, z], [x, a, z], [x + b, 0.0, z]
        e.scene.queue.push(e.scene.Triangle(*((v0, v2, v1) if flip else (v0, v1, v2))))
    return build_scene_buffers(e.scene, device), e.camera


def _scene_tables(tb, camera):
    _, _, _, w4, ids, mat = F.frame_inputs(tb, 4, 4, camera.position, camera.view_matrix(4, 4))
    return w4, ids, mat


def post_edge_args(name, device="cpu"):
    """(POST's arguments of the crafted case `name`, its cast rays): a
    state of RAYS live rays at bounce 0 of 3 (a dead ray's surface rows
    are what bounce_pre gives its carry, which a crafted state is not).
    The cast rays: (origin, shadow direction, next direction), [3] each."""
    a, b, y, x, flip, _ = POST_EDGES[name]
    zs = (0.0,) if name == "sdet_zero" else (1.0, -1.0)
    tb, camera = _triangle_scene([(a, b, x, z, flip) for z in zs], device)
    w4, ids, mat = _scene_tables(tb, camera)
    n = RAYS
    state = torch.zeros((F.SP_C, n), dtype=torch.float32, device=device)

    def put(row, values):
        for k, val in enumerate(values):
            state[row + k] = val

    put(F.RAY_ORIGIN, (0.0, y, 0.0))
    put(F.RAY_DIR, (0.0, 0.0, 1.0))
    put(F.LAST_HIT, (0.0, y, -1.0))
    put(F.IMPORTANCY, (1.0, 1.0, 1.0))
    put(F.ORIGINAL_COLOR, (1.0, 1.0, 1.0))
    put(F.DONT_FILTER, (1.0,))
    put(F.FIRST_RAY_LENGTH, (1.0,))
    put(F.SURF + 1, (0.0, 0.0, 1.0))   # the normal faces the ray: a mirror bounce to -z
    state[F.ALIVE] = 1.0
    state[F.SURF] = 1.0
    # albedo 0.5, rough 0, metal 0, emis 0, tpo (0, 0, 1): a solid mirror
    tex = torch.tensor([0.5, 0.5, 0.5, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0], device=device)
    tex = tex[:, None].expand(F.TEX_C, n).contiguous()
    ndc = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, (2, n)).astype(np.float32))
    lights = torch.tensor([[[0.0, y, 2.0], [10.0, 0.0, 0.0]]], device=device)
    cfg = Config(temporal=False, filter=False, antialiasing=None, rng="counter",
                 max_reflections=3)
    args = (state, tex, ndc.to(device), w4, ids, mat, lights,
            torch.tensor([0.0, 0.0, 5.0], device=device), 0.5, sample_cos(0), 0, cfg)
    o = torch.tensor([0.0, y, 0.0], device=device)
    return args, (o, torch.tensor([0.0, 0.0, 1.0], device=device),
                  torch.tensor([0.0, 0.0, -1.0], device=device))


def frame_edge_args(name, device="cpu"):
    """fused_frame's arguments of the crafted primary case `name`: RAYS
    rays from the camera at (0, y, 0) along +z, 1 spp, 3 bounces."""
    a, b, y, x, flip, _ = FRAME_EDGES[name]
    tb, camera = _triangle_scene([(a, b, x, 0.0 if name == "sdet_zero" else 1.0, flip)],
                                 device)
    w4, ids, mat = _scene_tables(tb, camera)
    dirs = torch.tensor([0.0, 0.0, 1.0], device=device)[:, None].expand(3, RAYS).contiguous()
    ndc = torch.from_numpy(np.random.default_rng(4).uniform(-1, 1, (2, RAYS)).astype(np.float32))
    cfg = Config(temporal=False, filter=False, antialiasing=None, rng="counter",
                 max_reflections=3, samples_per_ray=1)
    cos = torch.tensor([sample_cos(0)], dtype=torch.float32, device=device)
    return (dirs, ndc.to(device), w4, ids, mat, tb.lights, tb.ambient, tb.albedo_tab,
            tb.pbr_tab, tb.tpo_tab, torch.tensor([0.0, y, 0.0], device=device),
            torch.tensor(0.5, device=device), cos, cfg)


def pre_edge_args(name, t_total, device="cpu"):
    """PRE's arguments of FRAME_EDGES' case `name`: its triangle last after
    t_total - 1 far-off fillers (x >= 20, half of them back faces, each met
    by the rays' planes but outside its window), RAYS rays from the camera
    at (0, y, 0) along +z, the last with a zero direction (cast as +z)."""
    a, b, y, x, flip, _ = FRAME_EDGES[name]
    fillers = [(1.0, 1.0, 20.0 + 2 * k, 1.0, k % 2 == 1) for k in range(t_total - 1)]
    tb, camera = _triangle_scene(
        fillers + [(a, b, x, 0.0 if name == "sdet_zero" else 1.0, flip)], device)
    w4, ids, mat = _scene_tables(tb, camera)
    dirs = torch.tensor([0.0, 0.0, 1.0], device=device)[:, None].repeat(1, RAYS)
    dirs[:, -1] = 0.0
    cfg = Config(temporal=False, filter=False, antialiasing=None, rng="counter",
                 max_reflections=3)
    return (torch.zeros((F.SP_C, RAYS), dtype=torch.float32, device=device), dirs, w4, ids,
            mat, torch.tensor([0.0, y, 0.0], device=device), False, cfg)


def _products(w4, o, d):
    """(det, udet, vdet, sdet) [T] of the record of each triangle of W with
    the ray (o, d), as the kernels sum them."""
    rec = F.record_from_w4(w4)
    return record_products([rec[:, k] for k in range(16)], o, d)


def _cast(w4, ids, o, d, max_len, edge, closest):
    o3 = tuple(o[k].reshape(1) for k in range(3))
    d3 = tuple(d[k].reshape(1) for k in range(3))
    ml = torch.tensor([max_len], dtype=torch.float32, device=w4.device)
    if closest:
        return bool(closest_hit_plain(w4, ids, o3, d3, ml, edge)[3][0] >= 0)
    return bool(any_hit_plain(w4, o3, d3, ml)[0])


def check_post_edge(name, args, rays):
    """The crafted case is on its edge: the products and the plain casts'
    outcomes are the ones the case names."""
    expect = POST_EDGES[name][-1]
    w4, ids = args[3], args[4]
    o, d_shadow, d_next = rays
    det, udet, vdet, sdet = _products(w4, o, d_shadow)
    if name == "det_bias":
        assert float(det[0]) == BIAS
    elif name == "det_below_bias":
        assert 0.0 < float(det[0]) < BIAS
    elif name == "sdet_zero":
        assert float(sdet[0]) == 0.0
    elif name == "udet_zero":
        assert float(udet[0]) == 0.0
    elif name == "vdet_zero":
        assert float(vdet[0]) == 0.0
    elif name in ("u_on_edge", "u_below_edge"):
        u = float(udet[0] * (1.0 / det[0]))
        assert (u == BIAS) if name == "u_on_edge" else (0.0 < u < BIAS)
    else:
        assert float(det[0]) < 0.0
    assert (_cast(w4, ids, o, d_shadow, 2.0, BIAS, False),
            _cast(w4, ids, o, d_next, POW32, BIAS, True)) == expect


def check_frame_edge(name, args):
    expect = FRAME_EDGES[name][-1]
    w4, ids, cam = args[2], args[3], args[10]
    d = args[0][:, 0]
    det, udet, vdet, sdet = _products(w4, cam, d)
    if name == "u_zero":
        assert float(udet[0]) == 0.0
    elif name in ("u_on_edge", "u_past_edge"):
        u = float(udet[0] * (1.0 / det[0]))
        assert (u == -BIAS) if name == "u_on_edge" else (u < -BIAS)
    elif name == "det_minus_bias":
        assert float(det[0]) == -BIAS
    elif name == "sdet_zero":
        assert float(sdet[0]) == 0.0
    else:
        assert float(vdet[0]) == 0.0
    assert _cast(w4, ids, cam, d, POW32, -BIAS, True) == expect


def cap_engine(device):
    """wave with 9 x 9 pillars and 50 more triangles: 1024 triangles, the
    fused schemes' cap (a 64 KB record table)."""
    reset_global_registry()
    e, animate = wave(side_length=9, device=device)
    rng_np = np.random.default_rng(11)
    for _ in range(50):
        c = rng_np.uniform(-4, 12, 3).astype(np.float32)
        c[1] = abs(c[1])
        e.scene.queue.push(e.scene.Triangle(c, c + [0.5, 0.0, 0.0], c + [0.0, 0.5, 0.5]))
    animate(0)
    return e


def frame_args(tb, camera, size, cfg, device="cpu"):
    """fused_frame's arguments for camera's size x size frame over tb."""
    cam, dirs, ndc, w4, ids, mat = F.frame_inputs(tb, size, size, camera.position,
                                                   camera.view_matrix(size, size))
    cos = torch.tensor([sample_cos(s) for s in range(cfg.samples_per_ray)],
                       dtype=torch.float32, device=device)
    return (dirs, ndc, w4, ids, mat, tb.lights, tb.ambient, tb.albedo_tab, tb.pbr_tab,
            tb.tpo_tab, cam, torch.tensor(0.5, device=device), cos, cfg)


def pre_args(fargs):
    """PRE's arguments (casting, on a zero state) for the rays of
    fused_frame's arguments `fargs` (frame_args)."""
    dirs, _, w4, ids, mat = fargs[:5]
    state = torch.zeros((F.SP_C, dirs.shape[1]), dtype=torch.float32, device=dirs.device)
    return (state, dirs, w4, ids, mat, fargs[10], False, fargs[-1])


def post_calls(e, size, cfg, device="cpu"):
    """The inputs of every POST call of one size x size fused_split frame of
    engine `e` with the plain versions, recorded before each call."""
    calls = []

    def post(*a):
        calls.append(_clone(a))
        return PLAIN.sp_post(*a)

    tracer = PathTracer(size, size, e.scene, e.camera, cfg, device,
                        kernels=PLAIN._replace(sp_post=post))
    assert tracer.resolved_scheme() == "fused_split"
    tracer.render_frame()
    return calls


# ---- CPU: the emulated kernels ------------------------------------------------

def test_the_record_table_is_tri_record():
    """The records POST and FRAME build from W are tri_record's, on the
    1024-triangle scene."""
    e = cap_engine("cpu")
    tb = build_scene_buffers(e.scene, "cpu")
    assert tb.id_buffer.shape[0] == F.MAX_TRIS
    wg = world_geometry(tb)
    w4, _ = F.frame_inputs(tb, 4, 4, e.camera.position, e.camera.view_matrix(4, 4))[3:5]
    assert torch.equal(F.record_from_w4(w4), tri_record(wg, tb.id_buffer))


@needs_cxx
def test_the_live_list_lists_each_live_ray_once(lib):
    """The list kernel's entries are the rays with m = 1, each once; its
    count is theirs (m of every kind: 1, 0, -0, NaN, a denormal)."""
    rng_np = np.random.default_rng(5)
    for n in (1, 31, 32, 33, 1000):
        state = torch.zeros((F.SP_C, n), dtype=torch.float32)
        m = rng_np.choice(np.array([1.0, 0.0, -0.0, np.nan, 1e-40, 1.0], dtype=np.float32), n)
        state[F.SURF] = torch.from_numpy(m)
        got, count = SK._sp_live_list_launch(lib, 0, state)
        ref, ref_count = F.live_list_plain(state)
        k = int(ref_count)
        assert int(count) == k
        assert torch.equal(got[:k].sort().values, ref[:k])
        assert torch.equal(ref[:k], (state[F.SURF] > 0).nonzero().flatten().to(torch.int32))


@needs_cxx
def test_post_launches_its_list_through_the_counted_wrapper(lib, exact_sqrt):
    """POST's launch runs the list kernel once, counted by its own wrapper,
    and counts nothing else there (its own count is the caller's)."""
    args, _ = post_edge_args("det_bias")
    list_before, post_before = SK.sp_live_list.launches, SK.sp_post.launches
    got = SK._sp_post_launch(lib, 0, *_clone(args))
    assert SK.sp_live_list.launches == list_before + 1
    assert SK.sp_post.launches == post_before
    assert identical(got, F.sp_post_plain(*_clone(args)))


@needs_cxx
def test_post_on_an_all_dead_bounce_lists_none_and_writes_nothing(lib, exact_sqrt):
    args, _ = post_edge_args("det_bias")
    state = args[0]
    state[F.SURF] = 0.0
    before = state.clone()
    assert int(SK._sp_live_list_launch(lib, 0, state)[1]) == 0
    SK._sp_post_launch(lib, 0, *args)
    assert torch.equal(state, before)


@needs_cxx
@pytest.mark.parametrize("name", sorted(POST_EDGES))
def test_post_is_exact_on_the_bounce_casts_reject_edges(lib, exact_sqrt, name):
    args, rays = post_edge_args(name)
    check_post_edge(name, args, rays)
    got = SK._sp_post_launch(lib, 0, *_clone(args))
    ref = F.sp_post_plain(*_clone(args))
    assert identical(got, ref)


@needs_cxx
@pytest.mark.parametrize("name", sorted(FRAME_EDGES))
def test_frame_is_exact_on_the_primary_casts_reject_edges(lib, exact_sqrt, name):
    args = frame_edge_args(name)
    check_frame_edge(name, args)
    got = SK._fused_frame_launch(lib, 0, *args)
    ref = F.fused_frame_plain(*args)
    assert identical(got, ref)
    assert bool((got[F.FR_PPART + 3] >= 0).all()) == FRAME_EDGES[name][-1]


@needs_cxx
@pytest.mark.parametrize("t_total", [1, 20])
@pytest.mark.parametrize("name", sorted(FRAME_EDGES))
def test_pre_is_exact_on_the_primary_casts_reject_edges(lib, exact_sqrt, name, t_total):
    """PRE's cast on the record table, on FRAME's crafted primaries: every
    row of the state, the crafted triangle alone or last of 20."""
    check_frame_edge(name, frame_edge_args(name))
    args = pre_edge_args(name, t_total)
    assert args[2].shape[1] == t_total
    got = SK._sp_pre_launch(lib, 0, *_clone(args))
    ref = F.sp_pre_plain(*_clone(args))
    assert identical(got, ref)
    assert bool((ref[F.PPART + 3] >= 0).all()) == FRAME_EDGES[name][-1]


@needs_cxx
@pytest.mark.parametrize("rng_mode", ["counter", "hash"])
def test_post_is_exact_as_rays_die_at_each_bounce(lib, exact_sqrt, host_sin, rng_mode):
    """Every POST call of a theater frame (16x16, 5 bounces): rays die at
    every bounce, and the kernel over the live list is identical to the
    plain version on every call."""
    e = theater(stand_in_wood_texture(0), device="cpu")
    cfg = Config(temporal=False, filter=False, antialiasing=None, rng=rng_mode,
                 max_reflections=5)
    calls = post_calls(e, 16, cfg)
    live = [int((a[0][F.SURF] > 0).sum()) for a in calls]
    assert all(x > y for x, y in zip(live, live[1:])) and live[-1] > 0, live
    for a in calls:
        got = SK._sp_post_launch(lib, 0, *_clone(a))
        assert identical(got, F.sp_post_plain(*_clone(a))), a[-2]


@needs_cxx
def test_post_and_frame_are_exact_at_the_triangle_cap(lib, exact_sqrt):
    """The 1024-triangle scene (a 64 KB record table): PRE's cast, every
    POST call of a fused_split frame and the fused_frame block at 2 spp."""
    e = cap_engine("cpu")
    cfg = Config(temporal=False, filter=False, antialiasing=None, rng="counter",
                 max_reflections=3, samples_per_ray=2)
    for a in post_calls(e, 10, cfg):
        assert a[3].shape[1] == F.MAX_TRIS
        assert identical(SK._sp_post_launch(lib, 0, *_clone(a)), F.sp_post_plain(*_clone(a)))
    tb = build_scene_buffers(e.scene, "cpu")
    args = frame_args(tb, e.camera, 10, cfg)
    pre = pre_args(args)
    got = SK._sp_pre_launch(lib, 0, *_clone(pre))
    assert identical(got, F.sp_pre_plain(*_clone(pre)))
    got = SK._fused_frame_launch(lib, 0, *args)
    assert identical(got, F.fused_frame_plain(*args))
    assert (got[F.FR_PPART + 3] >= 0).sum() > 20


@needs_cxx
@pytest.mark.parametrize("spp", [1, 2])
def test_frame_lane_counts_count_each_live_ray_bounce_once(lib, exact_sqrt, spp):
    """lane_stats: emulated, a warp is one lane, so the lane-steps and the
    lane-steps that ran a bounce both equal the frame's live ray-bounces
    (the plain frame's rays with m = 1 over its POST calls)."""
    reset_global_registry()
    e, animate = wave(device="cpu")
    animate(0)
    cfg = Config(temporal=False, filter=False, antialiasing=None, rng="counter",
                 max_reflections=4, samples_per_ray=spp)
    tb = build_scene_buffers(e.scene, "cpu")
    args = frame_args(tb, e.camera, 12, cfg)
    args[0][:, ::3] = torch.tensor([0.0, 1.0, 0.0])[:, None]   # misses: dead from the start
    live = [0]

    def counting_post(state, *rest):
        live[0] += int((state[F.SURF] > 0).sum())
        return F.sp_post_plain(state, *rest)

    ref = F.split_frame(*args[:7], tb, *args[10:], F.sp_pre_plain, counting_post)
    stats = torch.zeros(2, dtype=torch.int32)
    got = SK._fused_frame_launch(lib, 0, *args, lane_stats=stats)
    assert identical(got, ref)
    assert stats.tolist() == [live[0], live[0]] and live[0] > 0
