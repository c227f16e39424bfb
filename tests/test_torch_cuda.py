"""The CUDA kernels on the card: each kernel wrapper on CUDA tensors
against its plain version on the same tensors, and a small theater frame
(and a small dragon stand-in frame, scheme="sparse", and a small wave
frame, scheme="fused") through all of them; a small rasterizer frame on
the dense and the worklist casts; on four cards, the sharded renders of
`flexlight_tpu_torch.parallel` over NCCL.
Marked `gpu`; without a CUDA device these tests skip (the NCCL test
without four).
Run on a machine with a card:

    python -m pytest -m gpu tests/test_torch_cuda.py

Expected agreement is bit for bit (the kernels take the plain versions'
operations in the same order, built without FMA contraction), except the
final pass, whose gamma curve torch's pow may round differently on the
card (1e-5). The fused PRE / POST kernels update their
state in place, so each side gets its own copy of the recorded state and
the two states must be identical."""

import numpy as np
import pytest
import torch

from flexlight_tpu_torch import Config

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _clone(args):
    return tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)


@pytest.fixture(scope="module")
def frame(dev):
    """One 96x64 theater frame with the plain versions on each scheme
    ("auto", which is fused_split for theater, and "kernel"), recording
    each kernel's first inputs; and the frames themselves."""
    from flexlight_tpu_torch.kernels import PLAIN, KernelSet
    from flexlight_tpu_torch.models.pathtracer import PathTracer
    from flexlight_tpu_torch.scenes import stand_in_wood_texture, theater

    captured = {}

    def recorder(name, fn):
        def rec(*a):
            captured.setdefault(name, _clone(a))
            return fn(*a)
        return rec

    kernels = KernelSet(*(recorder(n, f) for n, f in zip(KernelSet._fields, PLAIN)))
    e = theater(stand_in_wood_texture(0), device=dev)
    cfg = Config(temporal=True, temporal_samples=4, filter=True, antialiasing="fxaa",
                 samples_per_ray=1, max_reflections=5)
    imgs = {scheme: PathTracer(96, 64, e.scene, e.camera, cfg, dev, scheme=scheme,
                               kernels=kernels).render_frame()
            for scheme in ("auto", "kernel")}
    return captured, imgs, e, cfg


@pytest.mark.parametrize("name", ["closest_hit", "any_hit", "first_blur", "second_blur",
                                  "final_blur", "fxaa", "sp_pre", "sp_post"])
def test_kernel_matches_plain_on_the_card(frame, name):
    from flexlight_tpu_torch.kernels import KERNELS, PLAIN

    captured = frame[0]
    kernel = getattr(KERNELS, name)
    before = kernel.launches
    got = kernel(*_clone(captured[name]))
    ref = getattr(PLAIN, name)(*_clone(captured[name]))
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for a, b in zip(got, ref):
        assert a.is_cuda and a.dtype == b.dtype and a.shape == b.shape
        if name.startswith("sp_") or name == "fxaa":
            assert torch.equal(a, b)
        elif a.dtype.is_floating_point:
            torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
        else:
            assert torch.equal(a, b)


@pytest.mark.parametrize("scheme", ["auto", "kernel"])
def test_frame_through_the_kernels_matches_the_plain_frame(frame, dev, scheme):
    from flexlight_tpu_torch.kernels import KERNELS, KernelSet
    from flexlight_tpu_torch.models.pathtracer import PathTracer

    _, plain_imgs, e, cfg = frame
    counts = [k.launches for k in KERNELS]
    tracer = PathTracer(96, 64, e.scene, e.camera, cfg, dev, scheme=scheme)
    img = tracer.render_frame()
    ran = {n for n, k, c in zip(KernelSet._fields, KERNELS, counts) if k.launches > c}
    # on "kernel" the textured floor takes the shade kernel by default
    traversal = {"sp_pre", "sp_post"} if scheme == "auto" else {"closest_hit", "any_hit",
                                                                 "shade"}
    assert ran == traversal | {"first_blur", "second_blur", "final_blur", "fxaa"}
    assert img.shape == (64, 96, 3) and np.isfinite(img).all() and img.max() > 0
    d = np.abs(img - plain_imgs[scheme])
    assert (d > 2e-3).mean() <= 0.01 and d.max() <= 0.5


RASTER_SHADING = ("raster_surface", "raster_rays", "raster_shade")


@pytest.mark.parametrize("scheme", ["kernel", "sparse"])
def test_rasterizer_frame_through_the_kernels_is_the_plain_frame(frame, dev, scheme):
    """A small rasterizer frame (theater, 4 translucent layers, FXAA) on
    the dense and on the worklist casts: identical to its plain frame."""
    from flexlight_tpu_torch.kernels import KERNELS, PLAIN, KernelSet
    from flexlight_tpu_torch.models.rasterizer import Rasterizer

    _, _, e, _ = frame
    plain = Rasterizer(96, 64, e.scene, e.camera, Config(), dev, scheme=scheme,
                       kernels=PLAIN).render_frame()
    counts = [k.launches for k in KERNELS]
    r = Rasterizer(96, 64, e.scene, e.camera, Config(), dev, scheme=scheme)
    img = r.render_frame()
    ran = {n for n, k, c in zip(KernelSet._fields, KERNELS, counts) if k.launches > c}
    casts = {"closest_hit", "any_hit"} if scheme == "kernel" else \
        {"sparse_flags", "sparse_closest", "sparse_any"}
    assert ran == casts | {"fxaa"} | set(RASTER_SHADING) and r.resolved_layers() == 4
    assert np.isfinite(img).all() and img.max() > 0
    np.testing.assert_array_equal(img, plain)


def test_rasterizer_1080p_frame_shades_in_the_kernels(frame, dev):
    """theater at 1920x1080 on the engine's default renderer: each frame
    shades its 4 layers in csrc/raster.cu (a surface and a shade launch a
    layer, a ray launch a light and layer), and both frames equal the
    frames of the plain versions bit for bit."""
    from flexlight_tpu_torch.kernels import KERNELS, PLAIN
    from flexlight_tpu_torch.models.rasterizer import Rasterizer

    _, _, e, _ = frame
    plain = Rasterizer(1920, 1080, e.scene, e.camera, Config(), dev, kernels=PLAIN)
    want = [plain.render_frame() for _ in range(2)]
    del plain
    r = Rasterizer(1920, 1080, e.scene, e.camera, Config(), dev)
    layers, lights = r.resolved_layers(), r._buffers.lights.shape[0]
    assert r.resolved_scheme() == "kernel" and (layers, lights) == (4, 9)
    before = [getattr(KERNELS, n).launches for n in RASTER_SHADING]
    got = [r.render_frame() for _ in range(2)]
    counts = [getattr(KERNELS, n).launches - b for n, b in zip(RASTER_SHADING, before)]
    assert counts == [2 * layers, 2 * layers * lights, 2 * layers]
    for a, b in zip(got, want):
        assert a.shape == (1080, 1920, 3) and a.max() > 0
        np.testing.assert_array_equal(a, b)


SPARSE = ("sparse_flags", "sparse_key", "sparse_closest", "sparse_any")


@pytest.fixture(scope="module")
def sparse_frame(dev, tmp_path_factory):
    """One 128x64 frame of the dragon stand-in ("auto" resolves to
    "sparse") with the plain versions, recording each worklist kernel's
    inputs of its first call; and the frame."""
    from flexlight_tpu_torch import reset_global_registry
    from flexlight_tpu_torch.kernels import PLAIN, KernelSet
    from flexlight_tpu_torch.models.pathtracer import PathTracer
    from flexlight_tpu_torch.scenes import dragon

    captured = {}

    def recorder(name, fn):
        def rec(*a):
            captured.setdefault(name, a)
            return fn(*a)
        return rec

    kernels = KernelSet(*(recorder(n, f) for n, f in zip(KernelSet._fields, PLAIN)))
    reset_global_registry()
    e, animate = dragon(0, tmp_path_factory.mktemp("objects"), device=dev)
    animate(0.0)
    cfg = Config(temporal=True, temporal_samples=4, filter=True, antialiasing="fxaa",
                 samples_per_ray=1, max_reflections=3)
    tracer = PathTracer(128, 64, e.scene, e.camera, cfg, dev, kernels=kernels)
    assert tracer.resolved_scheme() == "sparse"
    return captured, tracer.render_frame(), e, cfg


@pytest.mark.parametrize("name", SPARSE)
def test_sparse_kernel_matches_plain_on_the_card(sparse_frame, name):
    from flexlight_tpu_torch.kernels import KERNELS, PLAIN

    args = sparse_frame[0][name]
    kernel = getattr(KERNELS, name)
    before = kernel.launches
    got = kernel(*args)
    ref = getattr(PLAIN, name)(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for a, b in zip(got, ref):
        assert a.is_cuda and a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_sparse_walk_with_a_mixed_ray_tile_matches_plain_on_the_card(dev):
    """The worklist casts on `walk_scene`'s ray tiles: in ray tile 0 the
    warps of rays 0-63 are done after slot 0 while those of rays 64-127 run
    to the end of 6 slots (longer than the tile ring); worklists of one
    tile and of none."""
    from flexlight_tpu_torch.ops import intersect_sparse as S
    from flexlight_tpu_torch.ops import intersect_sparse_kernel as K
    from flexlight_tpu_torch.ops.intersect import BIAS
    # by the name pytest collects it under (its rootdir insertion puts tests/
    # on the path); `tests.` would resolve to any `tests` package installed
    # in site-packages first
    from test_torch_sparse_record import walk_scene

    ws, wo3, wd3, wml, wlen = walk_scene(device=dev)
    for max_len, edge in ((wml, -BIAS), (wml, BIAS), (wlen, None)):
        o3, d3, ml, _ = S._prep_soa(wo3, wd3, max_len, 128)
        tlist, tms, counts = S._compact(K.flags_plain(ws.amin, ws.amax, o3, d3, ml, 128))
        assert counts.tolist() == [6, 1, 0, 0]
        if edge is None:
            hit = K.sparse_any(ws.rec, tlist, counts, o3, d3, ml, 128)
            assert hit.is_cuda and torch.equal(hit, K.any_plain(ws.rec, tlist, counts, o3, d3,
                                                                ml, 128))
            continue
        got = K.sparse_closest(ws.rec, tlist, tms, counts, o3, d3, ml, edge, 128)
        ref = K.closest_plain(ws.rec, tlist, tms, counts, o3, d3, ml, edge, 128)
        assert got[0].is_cuda and all(torch.equal(a, b) for a, b in zip(got, ref))
        assert (ref[3][:64] >= 0).eq(ml[:64] > 0).all() and (ref[3][64:128] == -1).all()


@pytest.mark.parametrize("name", ["denormal", "zero", "padding", "faces", "both_signs",
                                  "sparse_live", "many_boxes", "corner"])
def test_prepass_kernels_match_plain_on_crafted_inputs(dev, name):
    """The tile flags and the nearest2 key on test_torch_sparse_slab's
    inputs (denormal and zero direction components, padding boxes, origins
    on faces and inside nested boxes, 1 / d of both signs, one live ray, a
    dead warp beside live ones, more boxes than a shared chunk, the cull's
    exact corners), where every lane of a warp votes and reduces."""
    from flexlight_tpu_torch.ops import intersect_sparse_kernel as K
    from test_torch_sparse_slab import RT, corner_case, flags_inputs, key_inputs, slab_cases

    case = corner_case() if name == "corner" else slab_cases()[name]
    fa = flags_inputs(case, dev)
    got = K.sparse_flags(*fa, RT)
    assert got.is_cuda and torch.equal(got, K.flags_plain(*fa, RT))
    ka = key_inputs(case, dev)
    got = K.sparse_key(*ka)
    assert got.is_cuda and torch.equal(got, K.nearest2_key_plain(*ka))


def test_sparse_frame_through_the_kernels_matches_the_plain_frame(sparse_frame, dev):
    from flexlight_tpu_torch.kernels import KERNELS, KernelSet
    from flexlight_tpu_torch.models.pathtracer import PathTracer

    _, plain_img, e, cfg = sparse_frame
    counts = [k.launches for k in KERNELS]
    img = PathTracer(128, 64, e.scene, e.camera, cfg, dev).render_frame()
    ran = {n: k.launches - c for n, k, c in zip(KernelSet._fields, KERNELS, counts)
           if k.launches > c}
    assert ran == {"sparse_flags": 6, "sparse_key": 5, "sparse_closest": 3, "sparse_any": 3,
                   "interp_shade": 3, "first_blur": 3, "second_blur": 3, "final_blur": 1,
                   "fxaa": 1}
    assert img.shape == (64, 128, 3) and np.isfinite(img).all() and img.max() > 0
    d = np.abs(img - plain_img)
    assert (d > 2e-3).mean() <= 0.01 and d.max() <= 0.5


def test_default_route_shades_the_dragon_in_interp_shade(dev, tmp_path):
    """The default PathTracer on the dragon stand-in at 128x64 (sparse, 1x1
    atlases) launches interp_shade and its alive list once a bounce, its
    frames equal the shade_kernel=False frames bit for bit, and a frame's
    peak device memory (above what was allocated before it) is not above
    the eager frame's."""
    from flexlight_tpu_torch import reset_global_registry
    from flexlight_tpu_torch.kernels import KERNELS
    from flexlight_tpu_torch.models.pathtracer import PathTracer
    from flexlight_tpu_torch.ops import shade as S
    from flexlight_tpu_torch.ops import shade_kernel as HK
    from flexlight_tpu_torch.scenes import dragon

    reset_global_registry()
    e, animate = dragon(0, tmp_path / "objects", device=dev)
    cfg = Config(temporal=True, temporal_samples=4, filter=True, antialiasing="fxaa",
                 samples_per_ray=1, max_reflections=5)
    runs = {}
    for switch in (False, None):
        tracer = PathTracer(128, 64, e.scene, e.camera, cfg, dev, shade_kernel=switch)
        assert tracer.resolved_scheme() == "sparse"
        frames, peaks = [], []
        before = (KERNELS.interp_shade.launches, HK.alive_list.launches)
        for i in range(3):
            animate(float(i))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            frames.append(tracer.render_frame())
            peaks.append(torch.cuda.max_memory_allocated() - base)
        launched = (KERNELS.interp_shade.launches - before[0],
                    HK.alive_list.launches - before[1])
        runs[switch] = (frames, max(peaks[1:]), launched)
        del tracer
        torch.cuda.empty_cache()
    assert S.bounce_shading(e.renderer._buffers, "sparse", None, dev.type) == "interp_shade"
    assert runs[False][2] == (0, 0) and runs[None][2] == (3 * 5, 3 * 5)
    for a, b in zip(runs[None][0], runs[False][0]):
        assert np.isfinite(a).all() and a.max() > 0 and np.array_equal(a, b)
    assert runs[None][1] <= runs[False][1], (runs[None][1], runs[False][1])


@pytest.fixture(scope="module")
def shade_frames(dev, tmp_path_factory):
    """shade_kernel=True frames: theater at 96x64 on scheme="kernel" (its
    textured floor takes the shade kernel) and the dragon stand-in at
    128x64 ("auto": sparse; no textures, so interp_shade), each first with
    the plain versions, recording every shading call's inputs, then through
    the kernels, counting launches. Theater first: the dragon resets the
    transform registry."""
    from flexlight_tpu_torch import reset_global_registry
    from flexlight_tpu_torch.kernels import KERNELS, PLAIN, KernelSet
    from flexlight_tpu_torch.models.pathtracer import PathTracer
    from flexlight_tpu_torch.scenes import dragon, stand_in_wood_texture, theater

    calls = []

    def recorder(fn):
        def rec(*a):
            calls.append(_clone(a))
            return fn(*a)
        return rec

    cfg = Config(temporal=True, temporal_samples=4, filter=True, antialiasing="fxaa",
                 samples_per_ray=1, max_reflections=3)
    out = {}
    for name in ("theater", "dragon"):
        reset_global_registry()
        if name == "theater":
            e, animate, kind, size = theater(stand_in_wood_texture(0), device=dev), None, \
                "shade", (96, 64)
        else:
            e, animate = dragon(0, tmp_path_factory.mktemp("objects"), device=dev)
            kind, size = "interp_shade", (128, 64)
            animate(0.0)
        scheme = "kernel" if name == "theater" else "auto"
        calls.clear()
        plain = PLAIN._replace(**{kind: recorder(getattr(PLAIN, kind))})
        plain_img = PathTracer(*size, e.scene, e.camera, cfg, dev, scheme=scheme, kernels=plain,
                               shade_kernel=True).render_frame()
        counts = [k.launches for k in KERNELS]
        img = PathTracer(*size, e.scene, e.camera, cfg, dev, scheme=scheme,
                         shade_kernel=True).render_frame()
        ran = {n: k.launches - c for n, k, c in zip(KernelSet._fields, KERNELS, counts)
               if k.launches > c}
        out[name] = (kind, list(calls), plain_img, img, ran)
    return out


@pytest.mark.parametrize("name", ["theater", "dragon"])
def test_shade_kernels_match_plain_on_the_card(shade_frames, name):
    """Each shading call's state and request blocks: identical."""
    from flexlight_tpu_torch.kernels import KERNELS, PLAIN

    kind, calls, *_ = shade_frames[name]
    assert len(calls) == 3
    kernel = getattr(KERNELS, kind)
    for args in calls:
        before = kernel.launches
        got = kernel(*_clone(args))
        ref = getattr(PLAIN, kind)(*_clone(args))
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        for a, b in zip(got, ref):
            assert a.is_cuda and torch.equal(a, b)


@pytest.mark.parametrize("name", ["theater", "dragon"])
def test_shade_kernel_frame_matches_the_plain_frame(shade_frames, name):
    kind, _, plain_img, img, ran = shade_frames[name]
    post = {"first_blur": 3, "second_blur": 3, "final_blur": 1, "fxaa": 1}
    if name == "theater":
        assert ran == {"closest_hit": 3, "any_hit": 3, "shade": 3, **post}
    else:
        assert ran == {"sparse_flags": 6, "sparse_key": 5, "sparse_closest": 3,
                       "sparse_any": 3, "interp_shade": 3, **post}
    assert np.isfinite(img).all() and img.max() > 0
    d = np.abs(img - plain_img)
    assert (d > 2e-3).mean() <= 0.01 and d.max() <= 0.5


@pytest.fixture(scope="module")
def wave_frame(dev):
    """One 96x64 wave frame (full pipeline, 2 spp, 5 bounces) on
    scheme="fused" with the plain versions, recording fused_frame's
    inputs; and the frame."""
    from flexlight_tpu_torch import reset_global_registry
    from flexlight_tpu_torch.kernels import PLAIN
    from flexlight_tpu_torch.models.pathtracer import PathTracer
    from flexlight_tpu_torch.scenes import wave

    calls = []

    def recorder(*a):
        calls.append(a)
        return PLAIN.fused_frame(*a)

    reset_global_registry()
    e, animate = wave(device=dev)
    animate(0)
    cfg = Config(temporal=True, temporal_samples=4, filter=True, antialiasing="fxaa",
                 samples_per_ray=2, max_reflections=5)
    img = PathTracer(96, 64, e.scene, e.camera, cfg, dev, scheme="fused",
                     kernels=PLAIN._replace(fused_frame=recorder)).render_frame()
    return calls, img, e, cfg


def test_fused_frame_matches_plain_on_the_card(wave_frame):
    """The whole-frame kernel's block: identical to its plain version's
    (NaN equals NaN)."""
    from flexlight_tpu_torch.kernels import KERNELS, PLAIN

    calls = wave_frame[0]
    assert len(calls) == 1
    before = KERNELS.fused_frame.launches
    got = KERNELS.fused_frame(*calls[0])
    ref = PLAIN.fused_frame(*calls[0])
    torch.cuda.synchronize()
    assert KERNELS.fused_frame.launches == before + 1
    assert got.is_cuda and got.shape == ref.shape
    assert ((got == ref) | (torch.isnan(got) & torch.isnan(ref))).all()


def test_fused_frame_through_the_kernels(wave_frame, dev):
    """One launch of fused_frame per frame and no other tracing kernel;
    the frame within the golden budget of the plain frame; the MRT
    identical to scheme="fused_split"'s through its kernels."""
    from flexlight_tpu_torch.kernels import KERNELS, KernelSet
    from flexlight_tpu_torch.models.pathtracer import PathTracer
    from flexlight_tpu_torch.ops.pathtrace import render_mrt

    _, plain_img, e, cfg = wave_frame
    counts = [k.launches for k in KERNELS]
    tracer = PathTracer(96, 64, e.scene, e.camera, cfg, dev, scheme="fused")
    img = tracer.render_frame()
    ran = {n: k.launches - c for n, k, c in zip(KernelSet._fields, KERNELS, counts)
           if k.launches > c}
    assert ran == {"fused_frame": 1, "first_blur": 3, "second_blur": 3, "final_blur": 1,
                   "fxaa": 1}
    assert img.shape == (64, 96, 3) and np.isfinite(img).all() and img.max() > 0
    d = np.abs(img - plain_img)
    assert (d > 2e-3).mean() <= 0.01 and d.max() <= 0.5
    args = (tracer._buffers, 96, 64, e.camera.position, e.camera.view_matrix(96, 64), cfg,
            1.0)
    a = render_mrt(*args, scheme="fused")
    b = render_mrt(*args, scheme="fused_split")
    for x, y in zip(a, b):
        assert ((x == y) | (torch.isnan(x) & torch.isnan(y))).all()


# ---- POST over its live list and FRAME with lane refill (csrc/fused.cu) -----
# test_torch_fused_record's cases on the card (imported by the name pytest
# collects it under, as above)


def test_live_list_matches_plain_on_the_card(frame, dev):
    """The list kernel on the theater frame's state (bounce 0) and on a
    state with m of every kind: each live ray listed once, in runs of
    ascending order; two launches list the same rays."""
    from flexlight_tpu_torch.ops import fused as F
    from flexlight_tpu_torch.ops import fused_kernel as SK

    state = frame[0]["sp_post"][0].clone()
    other = torch.zeros((F.SP_C, 100_003), dtype=torch.float32, device=dev)
    m = np.random.default_rng(5).choice(
        np.array([1.0, 0.0, -0.0, np.nan, 1e-40, 1.0], dtype=np.float32), 100_003)
    other[F.SURF] = torch.from_numpy(m).to(dev)
    for st in (state, other):
        ref, ref_count = F.live_list_plain(st)
        k = int(ref_count)
        assert k > 0
        for _ in range(2):
            got, count = SK.sp_live_list(st)
            torch.cuda.synchronize()
            assert got.is_cuda and int(count) == k
            assert torch.equal(got[:k].sort().values, ref[:k])


def test_post_launches_are_identical_despite_the_list_order(frame):
    """Two POST launches on the same state (the list's order may differ
    between them) give identical states, equal to the plain version's;
    POST launches the list kernel once a call."""
    from flexlight_tpu_torch.kernels import KERNELS, PLAIN
    from flexlight_tpu_torch.ops import fused_kernel as SK
    from test_torch_fused_record import identical

    args = frame[0]["sp_post"]
    lists = SK.sp_live_list.launches
    a = KERNELS.sp_post(*_clone(args))
    b = KERNELS.sp_post(*_clone(args))
    ref = PLAIN.sp_post(*_clone(args))
    torch.cuda.synchronize()
    assert SK.sp_live_list.launches == lists + 2
    assert torch.equal(a, b) and identical(a, ref)


@pytest.mark.parametrize("name", ["det_bias", "det_below_bias", "sdet_zero", "udet_zero",
                                  "vdet_zero", "u_on_edge", "u_below_edge", "back_face"])
def test_post_is_exact_on_crafted_reject_edges_on_the_card(dev, name):
    from flexlight_tpu_torch.kernels import KERNELS, PLAIN
    from test_torch_fused_record import check_post_edge, identical, post_edge_args

    args, rays = post_edge_args(name, dev)
    check_post_edge(name, args, rays)
    got = KERNELS.sp_post(*_clone(args))
    assert got.is_cuda and identical(got, PLAIN.sp_post(*_clone(args)))


@pytest.mark.parametrize("name", ["u_zero", "u_on_edge", "u_past_edge", "det_minus_bias",
                                  "sdet_zero", "v_zero"])
def test_frame_is_exact_on_crafted_primary_edges_on_the_card(dev, name):
    from flexlight_tpu_torch.kernels import KERNELS, PLAIN
    from test_torch_fused_record import check_frame_edge, frame_edge_args, identical

    args = frame_edge_args(name, dev)
    check_frame_edge(name, args)
    got = KERNELS.fused_frame(*args)
    assert got.is_cuda and identical(got, PLAIN.fused_frame(*args))


@pytest.mark.parametrize("t_total", [1, 20])
@pytest.mark.parametrize("name", ["u_zero", "u_on_edge", "u_past_edge", "det_minus_bias",
                                  "sdet_zero", "v_zero"])
def test_pre_is_exact_on_crafted_primary_edges_on_the_card(dev, name, t_total):
    from flexlight_tpu_torch.kernels import KERNELS, PLAIN
    from test_torch_fused_record import (check_frame_edge, frame_edge_args, identical,
                                         pre_edge_args)

    check_frame_edge(name, frame_edge_args(name, dev))
    args = pre_edge_args(name, t_total, dev)
    got = KERNELS.sp_pre(*_clone(args))
    assert got.is_cuda and identical(got, PLAIN.sp_pre(*_clone(args)))


def test_post_and_frame_at_the_triangle_cap_on_the_card(dev):
    """The 1024-triangle scene: a 64 KB record table in dynamic shared
    memory (past the 48 KB that needs the kernels' attribute): PRE, every
    POST call and FRAME."""
    from flexlight_tpu_torch.kernels import KERNELS, PLAIN
    from flexlight_tpu_torch.ops import fused as F
    from flexlight_tpu_torch.ops.buffers import build_scene_buffers
    from test_torch_fused_record import (cap_engine, frame_args, identical, post_calls,
                                         pre_args)

    e = cap_engine(dev)
    cfg = Config(temporal=False, filter=False, antialiasing=None, rng="counter",
                 max_reflections=3, samples_per_ray=2)
    for a in post_calls(e, 48, cfg, dev):
        assert a[3].shape[1] == F.MAX_TRIS
        assert identical(KERNELS.sp_post(*_clone(a)), PLAIN.sp_post(*_clone(a)))
    args = frame_args(build_scene_buffers(e.scene, dev), e.camera, 48, cfg, dev)
    pre = pre_args(args)
    assert identical(KERNELS.sp_pre(*_clone(pre)), PLAIN.sp_pre(*_clone(pre)))
    got = KERNELS.fused_frame(*args)
    assert identical(got, PLAIN.fused_frame(*args))
    assert (got[F.FR_PPART + 3] >= 0).sum() > 100


def test_frame_lane_counts_on_the_card(wave_frame, dev):
    """lane_stats: the lane-steps that ran a bounce are the frame's live
    ray-bounces (the plain frame's rays with m = 1 over its POST calls),
    and the warps' lane-steps are whole warps, at least as many."""
    from flexlight_tpu_torch.ops import fused as F
    from flexlight_tpu_torch.ops import fused_kernel as SK

    args = wave_frame[0][0]
    live = [0]

    def counting_post(state, *rest):
        live[0] += int((state[F.SURF] > 0).sum())
        return F.sp_post_plain(state, *rest)

    atlases = F._Atlases(*args[7:10])
    ref = F.split_frame(*args[:7], atlases, *args[10:], F.sp_pre_plain, counting_post)
    stats = torch.zeros(2, dtype=torch.int32, device=dev)
    got = SK.fused_frame(*args, lane_stats=stats)
    torch.cuda.synchronize()
    lanes, busy = stats.tolist()
    assert ((got == ref) | (torch.isnan(got) & torch.isnan(ref))).all()
    assert busy == live[0] > 0 and lanes >= busy and lanes % 32 == 0


@pytest.mark.parametrize("case", ["blocky", "1x1", "7x37", "23x9", "tile_borders",
                                  "all_edges", "flat"])
def test_fxaa_on_tile_edges_on_the_card(dev, case):
    """test_torch_kernels_emulated's FXAA images: sizes no multiple of a
    tile, edges along and across the tile borders, every pixel an edge, a
    flat colour."""
    from flexlight_tpu_torch.post import fxaa_kernel as XK
    from test_torch_kernels_emulated import fxaa_image

    img = torch.from_numpy(fxaa_image(case)).to(dev)
    got = XK.fxaa_cuda(img)
    assert got.is_cuda and torch.equal(got, XK.fxaa_cuda.plain(img))


@pytest.mark.parametrize("t_total", [1, 20, 256, 257, 773])
@pytest.mark.parametrize("name", ["det_bias", "det_below_bias", "sdet_zero", "udet_zero",
                                  "vdet_zero", "u_on_edge", "u_below_edge", "back_face"])
def test_bounce_casts_are_exact_on_crafted_reject_edges_on_the_card(dev, name, t_total):
    """The traversal kernels on test_torch_trace_record's bounce cases:
    the crafted triangles last among fillers of W (T = 1 .. 3 chunks + 5)."""
    from flexlight_tpu_torch.ops import intersect_kernel as IK
    from flexlight_tpu_torch.ops.intersect import BIAS
    from test_torch_fused_record import identical
    from test_torch_trace_record import SIZES, bounce_edge_casts

    assert t_total in SIZES
    w4, ids, (so3, sd3, sml), (no3, nd3, nml) = bounce_edge_casts(name, t_total, dev)
    hit = IK.any_hit(w4, so3, sd3, sml)
    assert hit.is_cuda and torch.equal(hit, IK.any_hit_plain(w4, so3, sd3, sml))
    got = IK.closest_hit(w4, ids, no3, nd3, nml, BIAS)
    ref = IK.closest_hit_plain(w4, ids, no3, nd3, nml, BIAS)
    assert got[0].is_cuda and all(identical(a, b) for a, b in zip(got, ref))


@pytest.mark.parametrize("t_total", [1, 20, 256, 257, 773])
@pytest.mark.parametrize("name", ["u_zero", "u_on_edge", "u_past_edge", "det_minus_bias",
                                  "sdet_zero", "v_zero"])
def test_primary_casts_are_exact_on_crafted_reject_edges_on_the_card(dev, name, t_total):
    from flexlight_tpu_torch.ops import intersect_kernel as IK
    from flexlight_tpu_torch.ops.intersect import BIAS
    from test_torch_fused_record import identical
    from test_torch_trace_record import primary_edge_casts

    w4, ids, (o3, d3, ml) = primary_edge_casts(name, t_total, dev)
    got = IK.closest_hit(w4, ids, o3, d3, ml, -BIAS)
    ref = IK.closest_hit_plain(w4, ids, o3, d3, ml, -BIAS)
    assert got[0].is_cuda and all(identical(a, b) for a, b in zip(got, ref))


def test_the_cast_walk_across_chunks_on_the_card(dev):
    """walk_casts: within each block of 256 rays the any hits leave at
    triangles of every chunk, dead and short rays beside them (packed into
    the block's first threads)."""
    from flexlight_tpu_torch.ops import intersect_kernel as IK
    from flexlight_tpu_torch.ops.intersect import BIAS
    from test_torch_fused_record import identical
    from test_torch_trace_record import walk_casts

    w4, ids, o3, d3, ml, short = walk_casts(dev)
    for edge in (BIAS, -BIAS):
        got = IK.closest_hit(w4, ids, o3, d3, ml, edge)
        ref = IK.closest_hit_plain(w4, ids, o3, d3, ml, edge)
        assert got[0].is_cuda and all(identical(a, b) for a, b in zip(got, ref))
    hit = IK.any_hit(w4, o3, d3, short)
    assert torch.equal(hit, IK.any_hit_plain(w4, o3, d3, short)) and hit.any()


@pytest.mark.parametrize("mode", ["fast", "exact"])
@pytest.mark.parametrize("size", [(96, 160), (70, 150)])
def test_disc_passes_on_mixed_key_tiles_on_the_card(dev, size, mode):
    """test_torch_disc_tile's planes: key tiles at the 42-px reach, of no
    blur and of per-pixel keys, glass gates, sizes no multiple of a tile."""
    from flexlight_tpu_torch.post import filter_kernel as FK
    from test_torch_disc_tile import disc_planes

    planes = disc_planes(1, *size, mode, dev)
    for name in ("first_blur", "second_blur"):
        got = getattr(FK, name)(*planes)
        ref = getattr(FK, f"{name}_plain")(*planes)
        assert got[0].is_cuda and all(torch.equal(a, b) for a, b in zip(got, ref))
    for hdr in (True, False):
        got = FK.final_blur(*planes, hdr)
        torch.testing.assert_close(got, FK.final_blur_plain(*planes, hdr), atol=1e-6, rtol=0)


# ---- the shading kernels over their live lists (csrc/shade.cu) ---------------
# test_torch_shade_list's cases on the card (imported by the name pytest
# collects it under, as above), and its ragged case at 300,007 rays: no
# multiple of a block, and more rays than the persistent grid has threads


@pytest.mark.parametrize("case", ["all_dead", "all_live", "last_only", "alternate", "ragged",
                                  "stale_m", "killed", "bounce1", "hash", "hash_bounce1",
                                  "lights256", "ragged_large"])
@pytest.mark.parametrize("kind", ["shade", "interp_shade"])
def test_shade_list_walks_on_crafted_live_patterns_on_the_card(dev, kind, case):
    """Each call against its plain version, every row of both blocks; two
    launches (their lists' orders may differ) give identical blocks; each
    launch runs its list kernel once."""
    from flexlight_tpu_torch.kernels import KERNELS
    from flexlight_tpu_torch.ops import fused_kernel as SK
    from flexlight_tpu_torch.ops import shade_kernel as HK
    from test_torch_fused_record import identical
    from test_torch_shade_list import CASES, check_case, shade_case

    n = 300_007 if case == "ragged_large" else None
    args = shade_case(kind, *CASES[case.removesuffix("_large")], n=n, device=dev)
    kernel = getattr(KERNELS, kind)
    lists = SK.sp_live_list if kind == "shade" else HK.alive_list
    before = (lists.launches, kernel.launches)
    a = check_case(kind, args, kernel)
    b = kernel(*_clone(args))
    torch.cuda.synchronize()
    assert (lists.launches, kernel.launches) == (before[0] + 2, before[1] + 2)
    for x, y in zip(a, b):
        assert x.is_cuda and identical(x, y)


def test_the_alive_list_on_the_card(dev):
    """The alive list on alive of every kind: each alive ray listed once,
    in runs of ascending order, m = 0 written for the others; two launches
    list the same rays."""
    from flexlight_tpu_torch.ops import fused as F
    from flexlight_tpu_torch.ops import shade as S
    from flexlight_tpu_torch.ops import shade_kernel as HK
    from test_torch_fused_record import identical

    g = np.random.default_rng(5)
    state = torch.from_numpy(g.uniform(-1, 1, (S.ST_C, 100_003)).astype(np.float32)).to(dev)
    state[F.ALIVE] = torch.from_numpy(g.choice(
        np.array([1.0, 0.0, -0.0, np.nan, 1e-40, 1.0], dtype=np.float32), 100_003)).to(dev)
    ref_state = state.clone()
    ref, ref_count = S.alive_list_plain(ref_state)
    k = int(ref_count)
    assert k > 0
    for _ in range(2):
        st = state.clone()
        got, count = HK.alive_list(st)
        torch.cuda.synchronize()
        assert got.is_cuda and int(count) == k
        assert torch.equal(got[:k].sort().values, ref[:k])
        assert identical(st, ref_state)


def test_pipelined_frames_are_the_synchronous_frames_on_the_card(dev):
    """A depth-4 pipelined sequence on theater at 64x36 (the fetch goes
    through pinned memory, a non-blocking copy and an event): every frame
    is identical to the synchronous frame the warm-up rule names (frame 0
    for the first 5 calls, then 1, 2, ...). The camera moves every frame,
    so the frames differ from one another."""
    from flexlight_tpu_torch.models.pathtracer import PathTracer
    from flexlight_tpu_torch.scenes import stand_in_wood_texture, theater

    e = theater(stand_in_wood_texture(0), device=dev)
    cfg = Config(temporal=True, temporal_samples=4, filter=True, antialiasing="fxaa",
                 samples_per_ray=1, max_reflections=5)

    def run(depth, n=10):
        tracer = PathTracer(64, 36, e.scene, e.camera, cfg, dev)
        tracer.pipelined = depth
        x0, frames = e.camera.x, []
        for i in range(n):
            e.camera.x = x0 + 0.5 * i
            frames.append(tracer.render_frame_u8())
        e.camera.x = x0
        return frames

    sync = run(0)
    assert all(not np.array_equal(a, b) for i, a in enumerate(sync) for b in sync[i + 1:])
    frames = run(4)
    for i, f in enumerate(frames):
        assert f.dtype == np.uint8 and np.array_equal(f, sync[max(0, i - 4)]), i


def test_sharded_over_nccl_matches_one_process(dev, tmp_path):
    """Four cards, one rank each, on a 2 x 2 "cuda" mesh, which NCCL
    carries (tests/torch_parallel_ranks.py `_cuda2x2`): the 2-spp
    sample-sharded MRT against the one-process MRT (colour within 1e-4,
    the other channels at rtol 1e-4 / atol 1e-5, as on gloo), two frames
    of the strip-sharded halo pipeline identical to the one-process
    frames (displays and temporal rings), the halo exchange of device
    tensors equal to numpy's padding, and rank 0's scene on every rank."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices: a 2 x 2 mesh over NCCL, one card a rank")
    import torch_parallel_ranks as W
    from flexlight_tpu_torch import _native
    from flexlight_tpu_torch.models.pathtracer import frame_pipeline
    from flexlight_tpu_torch.ops.pathtrace import render_mrt

    _native.library()  # built once here, before the ranks load it
    ranks = W.spawn("cuda2x2", tmp_path)
    cfgs = W.configs()
    s = W.SIZE_MRT
    b, cam = W.scene(roughness=0.4, device=dev)
    one = render_mrt(b, s, s, cam.position, cam.view_matrix(s, s), cfgs["aux"], 0.0,
                     scheme="kernel")
    s = W.SIZE_POST
    br, camr = W.scene(roughness=0.05, device=dev)
    view = camr.view_matrix(s, s)
    ref = W.frames(lambda seed, tmp, taa: frame_pipeline(
        br, camr.position, view, seed, tmp, taa, s, s, cfgs["halo"], scheme="kernel"),
        cfgs["halo"], 2, s, dev)
    full = np.arange(16 * 3 * 2, dtype=np.float32).reshape(16, 3, 2)
    pad = np.concatenate([np.zeros((2, 3, 2), np.float32), full,
                          np.zeros((2, 3, 2), np.float32)])
    assert float(one.alpha.mean()) > 0.5 and float(ref[-1][0].max()) > 0.0
    for rank, res in enumerate(ranks):
        assert "nccl" in res["backend"], res["backend"]
        got = res["aux"]
        np.testing.assert_allclose(got[0].numpy(), one.color.cpu().numpy(), rtol=0, atol=1e-4)
        for field, x, y in list(zip(one._fields, got, one))[1:]:
            np.testing.assert_allclose(x.numpy(), y.cpu().numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=field)
        for f, ((display, state, _), want) in enumerate(zip(res["halo_frames"], ref)):
            assert torch.equal(display, want[0].cpu()), (rank, f)
            assert all(torch.equal(x, y.cpu()) for x, y in zip(state, want[1])), (rank, f)
        assert res["halo_device"] == f"cuda:{rank}"
        for i in range(2):
            np.testing.assert_array_equal(res["halo"][i].numpy(), pad[i * 8:i * 8 + 12])
        assert len(res["broadcast"]) == 20 and all(res["broadcast"]), rank
