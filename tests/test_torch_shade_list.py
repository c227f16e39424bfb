"""The shading kernels' walks over their live lists (csrc/shade.cu: shade
over POST's list of the rays with m = 1, interp_shade over its alive list,
whose pass also writes m = 0 for the rays that are not alive), compiled
for the host (-DFL_EMULATE: one block of one thread walks the whole list),
against their plain versions (ops/shade.py shade_plain,
interp_shade_plain) on seeded inputs with crafted live patterns: all dead
(the count is 0), all live, one live ray (the last), alternating rays, a
ragged N (250, no multiple of a block; shade's m of every kind: 1, 0, -0,
NaN, a denormal), rays that are not alive with a stale m = 1, rays the
importance test kills, bounce 1 (the first ray length), both RNG modes and
256 lights. The whole state and request blocks must be identical (NaN
equal to NaN), every row and every ray: a ray that is not listed gets
exactly the plain version's writes (none for shade, m = 0 for
interp_shade). The alive list lists each alive ray once.

As in tests/test_torch_fused_record.py (whose fixtures these tests use),
the plain versions take a correctly rounded sqrt (`exact_sqrt`) and,
under rng="hash", the C library's sinf (`host_sin`), which the emulated
kernels call. The `gpu` twins of these cases (`shade_case`) are in
tests/test_torch_cuda.py."""

import functools

import numpy as np
import pytest
import torch
from test_torch_fused_record import _clone, exact_sqrt, host_sin, identical, lib  # noqa: F401

from flexlight_tpu_torch import Config, reset_global_registry
from flexlight_tpu_torch.ops import fused as F
from flexlight_tpu_torch.ops import fused_kernel as SK
from flexlight_tpu_torch.ops import shade as S
from flexlight_tpu_torch.ops import shade_kernel as HK
from flexlight_tpu_torch.ops.buffers import build_scene_buffers
from flexlight_tpu_torch.ops.geometry import world_geometry
from flexlight_tpu_torch.ops.pathtrace import build_material_table
from flexlight_tpu_torch.scenes import stand_in_wood_texture, theater

N = 256
# case: (live pattern, bounce, rng mode, lights: the scene's 9 or 256 seeded)
CASES = {
    "all_dead": ("all_dead", 0, "counter", 9),
    "all_live": ("all_live", 0, "counter", 9),
    "last_only": ("last_only", 0, "counter", 9),
    "alternate": ("alternate", 0, "counter", 9),
    "ragged": ("ragged", 0, "counter", 9),
    "stale_m": ("stale_m", 0, "counter", 9),
    "killed": ("killed", 0, "counter", 9),
    "bounce1": ("alternate", 1, "counter", 9),
    "hash": ("alternate", 0, "hash", 9),
    "hash_bounce1": ("ragged", 1, "hash", 9),
    "lights256": ("alternate", 0, "counter", 256),
}
# the values of a ray that is not live (> 0 is false for each) and of a
# live one (a denormal is > 0)
DEAD = np.array([0.0, -0.0, np.nan], dtype=np.float32)
LIVE = np.array([1.0, 1e-40], dtype=np.float32)


@functools.lru_cache(maxsize=None)
def _theater():
    """Theater's material table (20 triangles; some rows read the 1x1
    atlas texel) and its 9 lights, as numpy."""
    reset_global_registry()
    e = theater(stand_in_wood_texture(0), device="cpu")
    tb = build_scene_buffers(e.scene, "cpu")
    mat = build_material_table(tb, world_geometry(tb)).clone()
    mat[::3, 27] = 0.0
    mat[1::4, 28] = 0.0
    mat[2::5, 29] = 0.0
    return mat.numpy(), tb.lights.numpy()


def _pattern(name, n, g, exotic):
    """[n] float32: the m (shade) or alive (interp_shade) row of a pattern;
    "ragged" with values of every kind where `exotic` (shade's m), else 0
    or 1 (alive, as the pipeline writes it from a bool: the plain
    interp_shade rewrites the row of every ray from its bool, the kernel
    only where the importance test kills)."""
    live = {"all_dead": np.zeros(n, bool), "all_live": np.ones(n, bool),
            "last_only": np.arange(n) == n - 1, "alternate": np.arange(n) % 2 == 0,
            "ragged": g.uniform(size=n) < 0.6, "stale_m": g.uniform(size=n) < 0.5,
            "killed": np.ones(n, bool)}[name]
    if name == "ragged" and exotic:
        return np.where(live, g.choice(LIVE, n), g.choice(DEAD, n)).astype(np.float32)
    return live.astype(np.float32)


def _unit(g, n):
    d = g.normal(size=(3, n)).astype(np.float32)
    return d / np.linalg.norm(d, axis=0)


def shade_case(kind, pattern, bounce, rng_mode, n_lights, n=None, device="cpu", seed=0):
    """The arguments of one `kind` call (shade or interp_shade) on seeded
    rays whose m (shade) or alive (interp_shade) row follows `pattern`: n
    rays (N, or 250 for "ragged"), theater's material table, its 9 lights
    or 256 seeded ones (some off), bounce `bounce`, Config(rng=rng_mode).
    "stale_m" sets m = 1 on every ray (interp_shade must write 0 where the
    ray is not alive) and alive = 0 where m is set (shade reads m only);
    "killed" makes every third ray's importance fall below the threshold."""
    g = np.random.default_rng(seed)
    n = n or (250 if pattern == "ragged" else N)
    mat, lights = _theater()
    if n_lights != lights.shape[0]:
        lights = np.zeros((n_lights, 2, 3), np.float32)
        lights[:, 0] = g.uniform(-8, 8, (n_lights, 3))
        lights[:, 1, 0] = np.where(g.uniform(size=n_lights) < 0.2, 0.0,
                                   g.uniform(5, 80, n_lights))
        lights[:, 1, 1] = g.uniform(0, 0.5, n_lights)
    row = _pattern(pattern, n, g, kind == "shade")
    u = g.uniform(0, 1, n).astype(np.float32)
    importancy = g.uniform(0.7, 1, (3, n)).astype(np.float32)
    if pattern == "killed":
        importancy[:, ::3] = 0.01
    carry = [np.ones(n, np.float32), g.integers(0, mat.shape[0], n).astype(np.float32),
             g.uniform(0.5, 8, n), u, g.uniform(0, 1, n) * (1 - u),
             *g.uniform(-4, 4, (3, n)), *_unit(g, n), *g.uniform(-4, 4, (3, n)),
             *importancy, *g.uniform(0.8, 1, (3, n)), g.uniform(size=n) > 0.4,
             *g.uniform(0, 2, (3, n)), *g.uniform(0, 0.5, (4, n)), g.integers(0, 2, n),
             *g.uniform(0, 1, (2, n)), g.uniform(0.2, 1, n)]
    surf = [np.ones(n, np.float32), *_unit(g, n), g.uniform(0, 0.01, n)]
    state = np.stack(carry + surf).astype(np.float32)
    if kind == "shade":
        state[S.SURF] = row
        if pattern == "stale_m":
            state[F.ALIVE] = np.where(row > 0, 0.0, 1.0)
    else:
        state[F.ALIVE] = row
        if pattern != "stale_m":
            state[S.SURF] = g.uniform(size=n) < 0.5
    t = lambda x: torch.tensor(np.asarray(x, np.float32), device=device)  # noqa: E731
    req = t(g.uniform(-1, 1, (S.REQ_C if kind == "shade" else S.REQ_STEP_C, n)))
    ndc = t(g.uniform(-1, 1, (2, n)))
    common = (t(lights), t([0.5, 1.0, -14.0]), t(np.float32(0.37)), t(np.float32(0.61)),
              bounce, Config(rng=rng_mode))
    if kind == "shade":
        tex = np.concatenate([g.uniform(0, 1, (6, n)), g.uniform(0, 1, (1, n)),
                              np.full((1, n), 0.5), g.uniform(1, 2, (1, n))])
        return (t(state), req, t(tex), ndc) + common
    return (t(state), req, ndc, t(mat), t(g.uniform(0.1, 0.9, 9))) + common


def check_case(kind, args, launch):
    """launch(*args) (the kernel) against the plain version on its own copy
    of the blocks: identical states and requests; the state's m row as the
    pattern has it (a live ray shaded, a listed one of interp_shade m =
    alive && the importance test)."""
    plain = S.shade_plain if kind == "shade" else S.interp_shade_plain
    got = launch(*_clone(args))
    ref = plain(*_clone(args))
    for block, a, b in zip(("state", "request"), got, ref):
        bad = (~((a == b) | (torch.isnan(a) & torch.isnan(b)))).any(dim=1).nonzero()
        assert not bad.numel(), (kind, block, bad.flatten().tolist())
    return got


# ---- CPU: the emulated kernels ----------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("kind", ["shade", "interp_shade"])
def test_shade_list_walks_are_exact_on_crafted_live_patterns(lib, exact_sqrt, host_sin, kind,
                                                             case):
    pattern = CASES[case][0]
    args = shade_case(kind, *CASES[case])
    launch = HK._shade_launch if kind == "shade" else HK._interp_shade_launch
    state = check_case(kind, args, lambda *a: launch(lib, 0, *a))[0]
    before = args[0]
    live = (before[S.SURF] if kind == "shade" else before[F.ALIVE]) > 0
    if pattern == "all_dead":
        assert not live.any()
    if kind == "shade":
        # unlisted rays: untouched; listed ones: shaded
        assert identical(state[:, ~live], before[:, ~live])
    else:
        assert not state[S.SURF][~live].any()
        shaded = state[S.SURF] > 0
        assert bool((shaded <= live).all())
        if pattern == "killed":
            assert int((live & ~shaded).sum()) == (live.numel() + 2) // 3
            assert not state[F.ALIVE][live & ~shaded].any()


@pytest.mark.parametrize("kind", ["shade", "interp_shade"])
def test_shade_kernels_launch_their_list_through_its_counted_wrapper(lib, exact_sqrt, kind):
    """shade's launch runs POST's list kernel once, interp_shade's the
    alive list once, each counted by its own wrapper; the shading
    kernel's own count is the caller's."""
    args = shade_case(kind, *CASES["alternate"])
    wrapper, lists = (HK.shade, SK.sp_live_list) if kind == "shade" else \
        (HK.interp_shade, HK.alive_list)
    launch = HK._shade_launch if kind == "shade" else HK._interp_shade_launch
    list_before, own_before = lists.launches, wrapper.launches
    check_case(kind, args, lambda *a: launch(lib, 0, *a))
    assert lists.launches == list_before + 1
    assert wrapper.launches == own_before


def test_the_alive_list_lists_each_alive_ray_once(lib):
    """The alive list's entries are the rays with alive > 0, each once; its
    count is theirs; every other ray gets m = 0 and nothing else changes
    (alive of every kind: 1, 0, -0, NaN, a denormal)."""
    g = np.random.default_rng(5)
    for n in (1, 31, 32, 33, 1000):
        state = torch.from_numpy(g.uniform(-1, 1, (S.ST_C, n)).astype(np.float32))
        state[F.ALIVE] = torch.from_numpy(g.choice(np.concatenate([DEAD, LIVE]), n))
        ref_state = state.clone()
        got, count = HK._alive_list_launch(lib, 0, state)
        ref, ref_count = S.alive_list_plain(ref_state)
        k = int(ref_count)
        assert int(count) == k
        assert torch.equal(got[:k].sort().values, ref[:k])
        assert torch.equal(ref[:k], (state[F.ALIVE] > 0).nonzero().flatten().to(torch.int32))
        assert identical(state, ref_state)
