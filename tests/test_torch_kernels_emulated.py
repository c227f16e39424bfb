"""The CUDA kernels of flexlight_tpu_torch/csrc, compiled for the host
(-DFL_EMULATE: every thread runs in turn as a block of one) and launched
through the same Python launch code as on the card, against their plain
PyTorch versions on the slice's kinds of input.

The kernels are written to take the plain versions' float operations in
the same order (and are built without FMA contraction), so the expected
agreement is bit for bit. The exceptions are the host's libm against
torch's CPU kernels, which the card does not share:
- the final pass's gamma curve: the host's powf and torch's pow may
  differ by an ulp (1e-6);
- the square root: the kernels' sqrtf is correctly rounded (as torch's is
  on the card), torch's float32 sqrt on the CPU is an ulp off for ~0.6% of
  inputs, so the fused-kernel tests put a correctly rounded sqrt into the
  plain versions (`exact_sqrt`) and then ask for identity;
- the hash RNG's sin: the host's sinf is not torch's CPU sin, and the
  hash amplifies an ulp into another random number (at 16 px through the
  whole denoise chain, 38% of the frame's values then move past 2e-3), so
  under rng="hash" the plain versions take the host's sinf (`host_sin`),
  as the hash tests against flexlight_tpu take its sin, and the kernels
  must again be identical to them.
The whole-frame kernel of scheme="fused" is held on wave, example2,
cornell and a cornell with small real textures, with some rays dead from
the first bounce. On the card, chip_smoke.py holds the same comparisons
at 1080p."""

import ctypes
import ctypes.util
import shutil

import numpy as np
import pytest
import torch

from flexlight_tpu_torch import Config, _native
from flexlight_tpu_torch.kernels import PLAIN, KernelSet
from flexlight_tpu_torch.models.pathtracer import PathTracer
from flexlight_tpu_torch.ops import fused as F
from flexlight_tpu_torch.ops import fused_kernel as SK
from flexlight_tpu_torch.ops import intersect_kernel as IK
from flexlight_tpu_torch.ops import rng
from flexlight_tpu_torch.ops import vec3 as v3
from flexlight_tpu_torch.ops.intersect import BIAS, POW32
from flexlight_tpu_torch.post import filter_kernel as FK
from flexlight_tpu_torch.post import fxaa as X
from flexlight_tpu_torch.post import fxaa_kernel as XK
from flexlight_tpu_torch.scenes import stand_in_wood_texture, theater

pytestmark = pytest.mark.skipif(shutil.which("g++") is None and shutil.which("c++") is None,
                                reason="no host C++ compiler for the emulated kernel build")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return _native.build_library(tmp_path_factory.mktemp("kernels"), emulate=True)


@pytest.fixture(scope="module")
def frame_inputs():
    """The first inputs each kernel gets in one real theater frame (full
    pipeline, 48x32, 3 bounces, scheme="kernel"), recorded from the plain
    run."""
    captured = {}

    def recorder(name, fn):
        def rec(*a):
            captured.setdefault(name, a)
            return fn(*a)
        return rec

    kernels = KernelSet(*(recorder(n, f) for n, f in zip(KernelSet._fields, PLAIN)))
    e = theater(stand_in_wood_texture(0), device="cpu")
    cfg = Config(temporal=True, temporal_samples=4, filter=True, antialiasing="fxaa",
                 samples_per_ray=1, max_reflections=3)
    PathTracer(48, 32, e.scene, e.camera, cfg, "cpu", scheme="kernel",
               kernels=kernels).render_frame()
    return captured


def _random_wavefront(n, seed):
    rng = np.random.default_rng(seed)
    o = tuple(torch.from_numpy(rng.uniform(-40, 40, n).astype(np.float32)) for _ in range(3))
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    d[:, ::17] = 0.0  # zero directions are cast as +z
    d = tuple(torch.from_numpy(np.ascontiguousarray(c)) for c in d)
    ml = torch.from_numpy(np.where(rng.uniform(size=n) < 0.1, 0.0,
                                   rng.uniform(0, 60, n)).astype(np.float32))
    return o, d, ml


def _same(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_closest_hit_kernel_is_bit_exact(lib, frame_inputs):
    w4, ids, o3, d3, ml, edge = frame_inputs["closest_hit"]
    _same(IK._closest_hit_launch(lib, 0, w4, ids, o3, d3, ml, edge),
          IK.closest_hit_plain(w4, ids, o3, d3, ml, edge))
    o, d, rml = _random_wavefront(3000, 1)
    rml = torch.where(rml > 0, POW32, 0.0)
    got = IK._closest_hit_launch(lib, 0, w4, ids, o, d, rml, BIAS)
    _same(got, IK.closest_hit_plain(w4, ids, o, d, rml, BIAS))
    assert (got[3] >= 0).any()


def test_any_hit_kernel_is_bit_exact(lib, frame_inputs):
    w4, o3, d3, ml = frame_inputs["any_hit"]
    _same([IK._any_hit_launch(lib, 0, w4, o3, d3, ml)], [IK.any_hit_plain(w4, o3, d3, ml)])
    o, d, rml = _random_wavefront(3000, 2)
    got = IK._any_hit_launch(lib, 0, w4, o, d, rml)
    _same([got], [IK.any_hit_plain(w4, o, d, rml)])
    assert got.any() and not got.all()


def _random_packed5(seed, h=24, w=40):
    """The five packed planes (ID, OID, COLOR, IP, OCOLOR) of random
    quantized images."""
    rng = np.random.default_rng(seed)
    q = lambda x: np.round(np.clip(x, 0, 1) * 255).astype(np.float32) * np.float32(1 / 255)
    ids = q(rng.uniform(0, 1, (5, 4)))[rng.integers(0, 5, (h, w))]
    oid = q(rng.uniform(0, 1, (3, 4)))[rng.integers(0, 3, (h, w))]
    color = q(rng.uniform(0, 1, (h, w, 4)))
    ip = q(np.where(rng.uniform(size=(h, w, 4)) < 0.3, rng.uniform(0, 0.3, (h, w, 4)), 0))
    ocw = q(np.where(rng.uniform(size=(h, w)) < 0.5, rng.uniform(0, 1, (h, w)), 0))
    ocolor = np.concatenate([q(rng.uniform(0, 1, (h, w, 3))), ocw[..., None]], -1)
    return tuple(FK.pack_rgba8(torch.from_numpy(x)) for x in (ids, oid, color, ip, ocolor))


@pytest.mark.parametrize("which", ["first", "second"])
def test_disc_passes_are_bit_exact(lib, frame_inputs, which):
    launch = getattr(FK, f"_{which}_blur_launch")
    plain = getattr(FK, f"{which}_blur_plain")
    for planes in (frame_inputs[f"{which}_blur"], _random_packed5(3)):
        _same(launch(lib, 0, *planes), plain(*planes))


@pytest.mark.parametrize("hdr", [True, False])
def test_final_pass_matches(lib, frame_inputs, hdr):
    for planes in (frame_inputs["final_blur"][:5], _random_packed5(4)):
        got = FK._final_blur_launch(lib, 0, *planes, hdr)
        ref = FK.final_blur_plain(*planes, hdr)
        assert got.shape == ref.shape == (*planes[0].shape, 3)
        torch.testing.assert_close(got, ref, atol=1e-6, rtol=0)


def fxaa_image(case: str) -> np.ndarray:
    """[H, W, 4] float32 inputs of FXAA against its tiles (csrc/fxaa.cu: 32 x
    16 pixels with a halo of 7): blocks of 8 px with alpha 0 or 1; seeded
    random cells at sizes that are no multiple of a tile; bars of 2 px whose
    edges run along the tile borders (rows 15 | 16, columns 31 | 32, 63 |
    64; and rows 7 | 8, a border of 8-row tiles) and across them, in both
    spans, beside a staircase; a 1-px checkerboard (every pixel an edge); a
    flat colour."""
    rng = np.random.default_rng(6)
    if case == "blocky":
        img = np.kron(rng.uniform(0, 1, (4, 5, 4)), np.ones((8, 8, 1))).astype(np.float32)
        img[..., 3] = (img[..., 3] > 0.3).astype(np.float32)
        return img
    if case in ("1x1", "7x37", "23x9"):
        h, w = (int(x) for x in case.split("x"))
        img = np.kron(rng.uniform(0, 1, ((h + 1) // 2, (w + 2) // 3, 4)), np.ones((2, 3, 1)))
        img = img[:h, :w].astype(np.float32)
        img[..., 3] = (img[..., 3] > 0.2).astype(np.float32)
        return img
    if case == "tile_borders":
        h, w = 24, 72
        img = np.full((h, w, 4), 0.1, np.float32)
        img[..., 3] = 1.0
        bright = rng.uniform(0.6, 1.0, 4).astype(np.float32)
        bright[3] = 1.0
        img[8:10, :] = bright                     # along the border of rows 7 | 8
        img[16:18, :] = bright                    # along the border of rows 15 | 16
        img[12:14, 20:50] = bright                # across columns 31 | 32
        img[:, 32:34] = bright                    # along the border of columns 31 | 32
        img[3:21, 62:64] = bright                 # ends at 63 | 64, across rows 7 | 8, 15 | 16
        for k in range(h):                        # a staircase across every border
            img[k, 2 * k + 5:2 * k + 8] = bright
        return img
    if case == "all_edges":
        h, w = 20, 40
        img = rng.uniform(0.3, 1.0, (h, w, 4)).astype(np.float32)
        img[..., 3] = 1.0
        img[(np.add.outer(np.arange(h), np.arange(w)) % 2) == 1, :3] = 0.0
        return img
    if case == "flat":
        img = np.empty((17, 35, 4), np.float32)
        img[:] = [0.4, 0.5, 0.6, 1.0]
        return img
    raise ValueError(case)


def low_contrast(img: torch.Tensor) -> torch.Tensor:
    """[H, W] bool: the pixels that FXAA's 3x3 test keeps as they are
    (post/fxaa.py's expressions)."""
    luma = X._luma(img)
    cross = [X._shift(luma, dy, dx) for dy, dx in ((-1, 0), (0, -1), (1, 0), (0, 1))]
    lo = torch.minimum(luma, torch.minimum(torch.minimum(cross[0], cross[1]),
                                           torch.minimum(cross[2], cross[3])))
    hi = torch.maximum(luma, torch.maximum(torch.maximum(cross[0], cross[1]),
                                           torch.maximum(cross[2], cross[3])))
    return (hi - lo) < torch.clamp_min(hi * X.EDGE_THRESHOLD, X.EDGE_THRESHOLD_MIN)


FXAA_CASES = ("blocky", "1x1", "7x37", "23x9", "tile_borders", "all_edges", "flat")


@pytest.mark.parametrize("case", ("frame",) + FXAA_CASES)
def test_fxaa_kernel_is_bit_exact(lib, frame_inputs, case):
    img = frame_inputs["fxaa"][0] if case == "frame" else torch.from_numpy(fxaa_image(case))
    got = XK._fxaa_launch(lib, 0, img)
    _same([got], [XK.fxaa_cuda.plain(img)])
    keep = low_contrast(img)
    if case == "all_edges":
        assert not keep.any()
    elif case == "flat":
        assert keep[1:-1, 1:-1].all() and not keep[0].any()
    elif case != "1x1":
        assert keep.any() and not keep.all()
    assert torch.equal(got[keep], img[keep])


def test_launch_checks_reject_what_the_kernel_does_not_take(lib):
    planes = _random_packed5(5)
    with pytest.raises(TypeError):
        FK._first_blur_launch(lib, 0, *planes[:4], planes[4].to(torch.int64))
    with pytest.raises(ValueError):
        FK._second_blur_launch(lib, 0, *planes[:4])
    with pytest.raises(ValueError):
        FK._final_blur_launch(lib, 0, *planes[:4], planes[4][:, :-1], True)
    with pytest.raises(ValueError):
        XK._fxaa_launch(lib, 0, torch.zeros(8, 8, 4).transpose(0, 1))
    with pytest.raises(ValueError):   # texels not 16-byte aligned
        XK._fxaa_launch(lib, 0, torch.zeros(8 * 8 * 4 + 1)[1:].view(8, 8, 4))


@pytest.fixture
def exact_sqrt(monkeypatch):
    """A correctly rounded float32 sqrt in the plain versions (see the
    module docstring)."""
    monkeypatch.setattr(v3, "sqrt", lambda x: torch.sqrt(x.double()).to(torch.float32))


@pytest.fixture
def host_sin(monkeypatch):
    """The C library's sinf, which the emulated kernels call, as the plain
    versions' hash sin."""
    sinf = ctypes.CDLL(ctypes.util.find_library("m")).sinf
    sinf.restype, sinf.argtypes = ctypes.c_float, [ctypes.c_float]
    monkeypatch.setattr(rng, "_sin", lambda x: torch.tensor(
        [sinf(float(a)) for a in x.reshape(-1).tolist()], dtype=torch.float32).reshape(x.shape))


def _clone(args):
    return tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)


def _fused_frame(lib, rng, spp, emulated: bool):
    """One theater frame at 16x16 (full pipeline, 5 bounces, `spp`
    samples, scheme="fused_split") with the plain versions, or with PRE and
    POST from the emulated build. Returns (image, the inputs of every PRE
    and POST call, recorded before the call)."""
    calls = []

    def recorder(name, fn):
        def rec(*a):
            calls.append((name, _clone(a)))
            return fn(*a)
        return rec

    if emulated:
        pre = lambda *a: SK._sp_pre_launch(lib, 0, *a)  # noqa: E731
        post = lambda *a: SK._sp_post_launch(lib, 0, *a)  # noqa: E731
    else:
        pre, post = PLAIN.sp_pre, PLAIN.sp_post
    kernels = PLAIN._replace(sp_pre=recorder("sp_pre", pre), sp_post=recorder("sp_post", post))
    e = theater(stand_in_wood_texture(0), device="cpu")
    cfg = Config(temporal=True, temporal_samples=4, filter=True, antialiasing="fxaa",
                 samples_per_ray=spp, max_reflections=5, rng=rng)
    tracer = PathTracer(16, 16, e.scene, e.camera, cfg, "cpu", kernels=kernels)
    assert tracer.resolved_scheme() == "fused_split"
    return tracer.render_frame(), calls


@pytest.mark.parametrize("rng_mode,spp", [("counter", 1), ("counter", 2), ("hash", 1)])
def test_fused_kernels_are_bit_exact(lib, exact_sqrt, host_sin, rng_mode, spp):
    """Every PRE and POST call of a theater frame (spp 2: the second PRE
    resamples), emulated kernel against plain version on the same state:
    identical, every row of the state. Then the frames are identical."""
    img, calls = _fused_frame(lib, rng_mode, spp, emulated=False)
    assert [n for n, _ in calls] == (["sp_pre"] + ["sp_post"] * 5) * spp
    for name, args in calls:
        launch = SK._sp_pre_launch if name == "sp_pre" else SK._sp_post_launch
        plain = F.sp_pre_plain if name == "sp_pre" else F.sp_post_plain
        got = launch(lib, 0, *_clone(args))
        ref = plain(*_clone(args))
        assert got.shape == (F.SP_C, 256)
        bad = (got != ref).any(dim=1).nonzero().flatten().tolist()
        assert not bad, (name, args[-2], bad)
    img_k, _ = _fused_frame(lib, rng_mode, spp, emulated=True)
    assert img.max() > 0
    np.testing.assert_array_equal(img_k, img)


def test_dead_rays_leave_the_state_unchanged_in_the_post_kernel(lib, exact_sqrt):
    """A POST call on a state whose rays are all dead writes nothing."""
    _, calls = _fused_frame(lib, "counter", 1, emulated=False)
    args = _clone(calls[1][1])
    state = args[0]
    state[F.ALIVE] = 0.0
    state[F.SURF] = 0.0
    before = state.clone()
    SK._sp_post_launch(lib, 0, *args)
    assert torch.equal(state, before)


def _shade_frame(lib, name, rng_mode, emulated: bool):
    """One 16x16 frame of `name` (full pipeline, 4 bounces,
    scheme="kernel", shade_kernel=True) with the plain versions, or with
    the shading kernels from the emulated build. Returns (image, the
    inputs of every shade / interp_shade call, recorded before the call)."""
    from flexlight_tpu_torch.ops import shade_kernel as HK
    from tests.test_torch_scene_copy import build

    calls = []

    def recorder(kind, fn):
        def rec(*a):
            calls.append((kind, _clone(a)))
            return fn(*a)
        return rec

    if emulated:
        shade = lambda *a: HK._shade_launch(lib, 0, *a)  # noqa: E731
        interp = lambda *a: HK._interp_shade_launch(lib, 0, *a)  # noqa: E731
    else:
        shade, interp = PLAIN.shade, PLAIN.interp_shade
    kernels = PLAIN._replace(shade=recorder("shade", shade),
                             interp_shade=recorder("interp_shade", interp))
    import flexlight_tpu_torch as port

    scene, camera = build(name, port)
    cfg = Config(temporal=True, temporal_samples=4, filter=True, antialiasing="fxaa",
                 samples_per_ray=1, max_reflections=4, rng=rng_mode)
    tracer = PathTracer(16, 16, scene, camera, cfg, "cpu", scheme="kernel", kernels=kernels,
                        shade_kernel=True)
    return tracer.render_frame(), calls


@pytest.mark.parametrize("name,kind", [("theater", "shade"), ("cornell", "interp_shade")])
@pytest.mark.parametrize("rng_mode", ["counter", "hash"])
def test_shade_kernels_are_bit_exact(lib, exact_sqrt, host_sin, name, kind, rng_mode):
    """Every shading call of a frame (theater: textured, so shade; cornell:
    1x1 atlases, so interp_shade), emulated kernel against plain version on
    the same state and request blocks: identical. Then the frames are."""
    from flexlight_tpu_torch.ops import shade as H
    from flexlight_tpu_torch.ops import shade_kernel as HK

    img, calls = _shade_frame(lib, name, rng_mode, emulated=False)
    assert [k for k, _ in calls] == [kind] * 4
    launch = HK._shade_launch if kind == "shade" else HK._interp_shade_launch
    plain = H.shade_plain if kind == "shade" else H.interp_shade_plain
    for _, args in calls:
        got = launch(lib, 0, *_clone(args))
        ref = plain(*_clone(args))
        assert (got[0][H.SURF] > 0).any()
        for block, a, b in zip(("state", "request"), got, ref):
            bad = (a != b).any(dim=1).nonzero().flatten().tolist()
            assert not bad, (kind, args[-2], block, bad)
    img_k, _ = _shade_frame(lib, name, rng_mode, emulated=True)
    assert img.max() > 0
    np.testing.assert_array_equal(img_k, img)


def test_dead_rays_are_left_alone_by_the_shade_kernels(lib, exact_sqrt):
    """shade on rays with m = 0 writes nothing; interp_shade on rays that
    are not alive writes m = 0 and nothing else."""
    from flexlight_tpu_torch.ops import shade as H
    from flexlight_tpu_torch.ops import shade_kernel as HK

    for name, kind in (("theater", "shade"), ("cornell", "interp_shade")):
        _, calls = _shade_frame(lib, name, "counter", emulated=False)
        state, req = _clone(calls[1][1][:2])
        args = (state, req) + calls[1][1][2:]
        if kind == "shade":
            state[H.SURF] = 0.0
        else:
            state[F.ALIVE] = 0.0
            state[H.SURF] = 1.0
        before, req_before = state.clone(), req.clone()
        launch = HK._shade_launch if kind == "shade" else HK._interp_shade_launch
        launch(lib, 0, *args)
        if kind == "interp_shade":
            assert not state[H.SURF].any()
            before[H.SURF] = 0.0
        assert torch.equal(state, before) and torch.equal(req, req_before), kind


def _fused_frame_args(name, spp, rng_mode, dead=False, size=12):
    """The inputs of one fused_frame call: `name`'s camera rays at size x
    size, its scene tables, seed 1 and the samples' phases. `dead` points
    every fifth ray straight up, past every triangle: those rays are dead
    from the first bounce. "textured" is cornell with small real textures
    (8x2 standard tiles, a u8 albedo table with one 4x1 texture stored at
    its own size, an f32 PBR table) on the cubes and the floor."""
    import flexlight_tpu_torch as port
    from flexlight_tpu_torch.ops.buffers import build_scene_buffers
    from flexlight_tpu_torch.ops.pathtrace import sample_cos
    from tests.test_torch_scene_copy import build

    scene, camera = build("cornell" if name == "textured" else name, port)
    if name == "textured":
        rng_np = np.random.default_rng(7)
        byte = lambda shape: (rng_np.integers(0, 256, shape).astype(np.float32)  # noqa: E731
                              * np.float32(1.0 / 255.0))
        scene.standardTextureSizes = [8, 2]
        scene.textures.push(port.Texture(byte((2, 8, 3))), port.Texture(byte((1, 4, 3))))
        scene.pbr_textures.push(port.Texture(rng_np.uniform(0, 1, (2, 8, 3)).astype(np.float32)))
        scene.queue[0][0].textureNums = [0, 0, -1]
        scene.queue[0][1].textureNums = [1, -1, -1]
        scene.queue[1][0].textureNums = [1, 0, -1]
    tb = build_scene_buffers(scene, "cpu")
    cfg = Config(temporal=False, filter=False, antialiasing=None, rng=rng_mode,
                 max_reflections=3, samples_per_ray=spp)
    cam, dirs, ndc, w4, ids, mat = F.frame_inputs(tb, size, size, camera.position,
                                                   camera.view_matrix(size, size))
    if dead:
        dirs[:, ::5] = torch.tensor([0.0, 1.0, 0.0])[:, None]
    cos = torch.tensor([sample_cos(s) for s in range(spp)], dtype=torch.float32)
    return (dirs, ndc, w4, ids, mat, tb.lights, tb.ambient, tb.albedo_tab, tb.pbr_tab,
            tb.tpo_tab, cam, torch.tensor(1.0), cos, cfg), tb


@pytest.mark.parametrize("name,spp,rng_mode,dead", [
    ("wave", 2, "counter", True), ("wave", 1, "hash", False), ("example2", 1, "counter", False),
    ("cornell", 2, "counter", False), ("textured", 1, "counter", False)])
def test_fused_frame_kernel_is_bit_exact(lib, exact_sqrt, host_sin, name, spp, rng_mode, dead):
    """The whole-frame kernel against its plain version (the fused_split
    frame with the plain PRE and POST): every channel of the frame block
    identical. wave takes its plane's roughness from a 2x2048 PBR atlas;
    "textured" walks the fetch's tiles, stored sizes and both texel
    types."""
    args, tb = _fused_frame_args(name, spp, rng_mode, dead)
    if name == "textured":
        assert tb.albedo_tab.texels.dtype == torch.uint8
        assert tb.pbr_tab.texels.dtype == torch.float32
        assert tb.albedo_tab.tile_info[1].tolist()[1:] == [4, 1]
    got = SK._fused_frame_launch(lib, 0, *args)
    ref = F.fused_frame_plain(*args)
    assert got.shape == (F.FR_C, 144)
    bad = (got != ref).any(dim=1).nonzero().flatten().tolist()
    assert not bad, bad
    alive = got[F.FR_PPART + 3] >= 0
    assert alive.any() and (got[F.FR_COLOR][alive] > 0).any()
    if dead:
        assert not alive[::5].any() and alive.sum() > 100


def test_fused_frame_kernel_renders_the_plain_frame(lib, exact_sqrt):
    """A wave frame (full pipeline, 16x16, 2 spp, 5 bounces) through
    PathTracer(scheme="fused") with the emulated kernel is the frame with
    the plain version."""
    from flexlight_tpu_torch import reset_global_registry
    from flexlight_tpu_torch.scenes import wave

    cfg = Config(temporal=True, temporal_samples=4, filter=True, antialiasing="fxaa",
                 samples_per_ray=2, max_reflections=5, rng="counter")
    launch = lambda *a: SK._fused_frame_launch(lib, 0, *a)  # noqa: E731
    frames = []
    for kernels in (PLAIN, PLAIN._replace(fused_frame=launch)):
        reset_global_registry()
        e, animate = wave(device="cpu")
        animate(0)
        tracer = PathTracer(16, 16, e.scene, e.camera, cfg, "cpu", scheme="fused",
                            kernels=kernels)
        frames.append(tracer.render_frame())
    assert frames[0].max() > 0
    np.testing.assert_array_equal(frames[1], frames[0])
