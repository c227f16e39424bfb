"""The shading kernels' plain versions (ops.shade: shade_plain for kernel
11, interp_shade_plain for kernel 12) against flexlight_tpu's
make_shade_bounce_post / make_fused_bounce_step, run both with
pallas=False (the kernel bodies traced as plain XLA ops) and with
interpret=True, on the same seeded inputs: a 256-ray wavefront (one ray
tile) with dead rays, an importance kill, 4 lights (one switched off),
bounces 0, 1 and 3, both RNG modes (interpret mode: the counter RNG only,
since under the hash the jitted kernel body's sin draws other random
numbers, tests/test_fused.py:481-493).

Compared, with flexlight_tpu's bounce_apply intercepted to read its
request and its carry before bounce_apply:
- the carry that the kernel returns (every ray; a dead ray's is unchanged);
- the request on the live rays. A dead ray's request columns are not
  written by the port's kernels (the drop-in masks what bounce_apply reads
  of them), so they are not compared;
- the shadow cast's request (offset target, direction, length, alive);
- the carry after the whole bounce (bounce_apply and bounce_commit with the
  same stubbed shadow and closest-hit results), every ray.
Tolerances: rtol 1e-5 / atol 1e-6 (the same float operations in the same
order); under rng="counter" (integer hash) the color (final_color) is
held exactly against the op-by-op kernel body (pallas=False). Under rng="hash" the port takes flexlight_tpu's sin
(`reference_sin`), as the other hash tests do. The port takes a correctly
rounded square root (`exact_sqrt`), as XLA's is: torch's float32 sqrt on
the CPU is an ulp off for ~1% of inputs (ops/vec3.py sqrt), which the
exact color check would see.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import flexlight_tpu as jpkg  # noqa: E402
from flexlight_tpu.ops import buffers as jbuf  # noqa: E402
from flexlight_tpu.ops import fused as jfused  # noqa: E402
from flexlight_tpu.ops import pathtrace as jpt  # noqa: E402
import flexlight_tpu_torch as port  # noqa: E402
from flexlight_tpu_torch.ops import pathtrace as tpt  # noqa: E402
from flexlight_tpu_torch.ops import rng as trng  # noqa: E402
from flexlight_tpu_torch.ops import shade as S  # noqa: E402
from flexlight_tpu_torch.ops import vec3 as v3  # noqa: E402
from flexlight_tpu_torch.ops.buffers import buffers_from_numpy  # noqa: E402
from flexlight_tpu_torch.ops.fused import carry_from_state  # noqa: E402
from flexlight_tpu_torch.ops.geometry import world_geometry  # noqa: E402
from tests.scenes import cornell_scene  # noqa: E402

N = 256
PLAIN_SHADE = SimpleNamespace(shade=S.shade_plain, interp_shade=S.interp_shade_plain)


@pytest.fixture
def reference_sin(monkeypatch):
    """flexlight_tpu's sin in the port's hash."""
    monkeypatch.setattr(trng, "_sin", lambda x: torch.from_numpy(np.array(
        jnp.sin(jnp.asarray(x.numpy())))))


@pytest.fixture
def exact_sqrt(monkeypatch):
    """A correctly rounded float32 sqrt in the port's shading."""
    monkeypatch.setattr(v3, "sqrt", lambda x: torch.sqrt(x.double()).to(torch.float32))


@pytest.fixture(scope="module")
def scene():
    """cornell's buffers in both packages, with 4 seeded lights (the last
    one off) and seeded 1x1 atlas texels; its material table."""
    rng = np.random.default_rng(11)
    jb = jbuf.build_scene_buffers(cornell_scene()[0])
    lights = np.zeros((4, 2, 3), np.float32)
    lights[:, 0] = rng.uniform(-3, 3, (4, 3))
    lights[:, 0, 1] = 4.0
    lights[:, 1, 0] = rng.uniform(20, 60, 4)
    lights[:, 1, 1] = rng.uniform(0, 0.4, 4)
    lights[3, 1, 0] = 0.0
    atl = rng.uniform(0.1, 0.9, (3, 1, 1, 3)).astype(np.float32)
    jb = jb._replace(lights=jnp.asarray(lights), albedo_atlas=jnp.asarray(atl[0]),
                     pbr_atlas=jnp.asarray(atl[1]), tpo_atlas=jnp.asarray(atl[2]))
    tb = buffers_from_numpy(jax.tree.map(np.asarray, jb), "cpu")
    mat = tpt.build_material_table(tb, world_geometry(tb)).clone()
    # some rows read their textures: the 1x1 atlases' texel
    mat[::3, 27] = 0.0
    mat[1::4, 28] = 0.0
    mat[2::5, 29] = 0.0
    return jb, tb, mat.contiguous()


def _unit(rng, n):
    d = rng.normal(size=(3, n)).astype(np.float32)
    return d / np.linalg.norm(d, axis=0)


def _inputs(seed, tris):
    """Seeded carry (hitting the triangle slots `tris`), surface, textures,
    pixel NDC, shadow results and next hits, as numpy."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(0, 1, N).astype(np.float32)
    v = (rng.uniform(0, 1, N) * (1 - u)).astype(np.float32)
    alive = rng.uniform(size=N) > 0.15
    importancy = rng.uniform(0.2, 1, (3, N)).astype(np.float32)
    importancy[:, ::37] = 0.01  # the importance kill
    c = dict(
        alive=alive, tri=rng.choice(tris, N).astype(np.int32),
        hs=rng.uniform(0.5, 8, N).astype(np.float32), hu=u, hv=v,
        ray_origin=rng.uniform(-4, 4, (3, N)).astype(np.float32),
        ray_dir=_unit(rng, N),
        last_hit_point=rng.uniform(-4, 4, (3, N)).astype(np.float32),
        importancy=importancy,
        original_color=rng.uniform(0.3, 1, (3, N)).astype(np.float32),
        dont_filter=rng.uniform(size=N) > 0.4,
        final_color=rng.uniform(0, 2, (3, N)).astype(np.float32),
        render_id=rng.uniform(0, 0.5, (4, N)).astype(np.float32),
        glass=rng.integers(0, 2, N).astype(np.float32),
        original_rme_x=rng.uniform(0, 1, N).astype(np.float32),
        original_tpo_x=rng.uniform(0, 1, N).astype(np.float32),
        first_ray_length=rng.uniform(0.2, 1, N).astype(np.float32))
    surf = dict(m=alive & (rng.uniform(size=N) > 0.1), smooth_normal=_unit(rng, N),
                geometry_offset=rng.uniform(0, 0.01, N).astype(np.float32))
    tex = np.concatenate([rng.uniform(0, 1, (3, N)), rng.uniform(0, 1, (3, N)) * [[1], [1], [0.3]],
                          rng.uniform(0, 1, (1, N)), np.full((1, N), 0.5),
                          rng.uniform(1, 2, (1, N))]).astype(np.float32)
    ndc = rng.uniform(-1, 1, (2, N)).astype(np.float32)
    shadowed = rng.uniform(size=N) < 0.3
    hit = (rng.uniform(0.5, 9, N).astype(np.float32), rng.uniform(0, 0.5, N).astype(np.float32),
           rng.uniform(0, 0.5, N).astype(np.float32),
           np.where(rng.uniform(size=N) < 0.2, -1, rng.choice(tris, N)).astype(np.int32))
    return c, surf, tex, ndc, shadowed, hit


def _fields3(x):
    return tuple(x[k] for k in range(3))


def _carries(c):
    """(port BounceCarry of [N] tensors, JAX BounceCarry of [1, N] arrays)."""
    t = {k: (_fields3(torch.from_numpy(x)) if x.ndim == 2 and k != "render_id"
             else tuple(torch.from_numpy(x)) if k == "render_id" else torch.from_numpy(x))
         for k, x in c.items()}
    tc = tpt.BounceCarry(**t)

    def j(x):
        return jnp.asarray(x)[None]

    jc = jpt.BounceCarry(
        **{k: (tuple(j(r) for r in x) if x.ndim == 2 else j(x)) for k, x in c.items()},
        original_id_acc=tuple(jnp.zeros((1, N), jnp.float32) for _ in range(4)))
    return tc, jc


def _jax_bounce(kind, jb, mat, c, surf, tex, ndc, i, cfg, shadowed, hit, monkeypatch,
                pallas, seed, cos):
    """flexlight_tpu's drop-in on the inputs; (carry before bounce_apply,
    request, textures bounce_apply reads, shadow-cast arguments, carry
    after the bounce)."""
    seen = {}
    apply = jfused.bounce_apply

    def spy(carry, tex_, req, shadowed_, i_, config_):
        seen["carry"], seen["req"], seen["tex"] = carry, req, tex_
        return apply(carry, tex_, req, shadowed_, i_, config_)

    monkeypatch.setattr(jfused, "bounce_apply", spy)

    def shadow_soa(o3, d3, max_len, alive=None, hint=None):
        seen["shadow"] = (o3, d3, max_len, alive)
        return jnp.asarray(shadowed)[None]

    def traverse_soa(o3, d3, alive=None, hint=None):
        return tuple(jnp.asarray(x)[None] for x in hit)

    _, jc = _carries(c)
    ndc2 = (jnp.asarray(ndc[0])[None], jnp.asarray(ndc[1])[None])
    kw = dict(pallas=pallas, interpret=None if not pallas else True)
    jcfg = jpkg.Config(**vars(cfg))
    cam = jnp.asarray([0.5, 1.0, -14.0], jnp.float32)
    if kind == "shade":
        z = jnp.zeros((1, N), jnp.float32)
        jsurf = jpt.BounceSurface(
            m=jnp.asarray(surf["m"])[None],
            smooth_normal=tuple(jnp.asarray(r)[None] for r in surf["smooth_normal"]),
            geometry_offset=jnp.asarray(surf["geometry_offset"])[None], bary_u=z, bary_v=z,
            tex_nums=(z,) * 3, inline_albedo=(z,) * 3, inline_rme=(z,) * 3,
            inline_tpo=(z,) * 3)
        jt = [jnp.asarray(r)[None] for r in tex]
        jtex = (tuple(jt[0:3]), jt[3], jt[4], jt[5], tuple(jt[6:9]))
        fn = jfused.make_shade_bounce_post(jb, cam, jcfg, **kw)
        out = fn(jc, jsurf, jtex, i, jb, cam, ndc2, jnp.float32(cos), jcfg, jnp.float32(seed),
                 traverse_soa, shadow_soa)
    else:
        fn = jfused.make_fused_bounce_step(jb, cam, jcfg, **kw)
        out = fn(jc, i, jnp.asarray(mat.numpy()), ndc2, jnp.float32(cos), jnp.float32(seed),
                 traverse_soa, shadow_soa)
    return seen["carry"], seen["req"], seen["tex"], seen["shadow"], out


def _port_state(tc, surf=None):
    state = torch.zeros((S.ST_C, N))
    S._pack_rows(state, S._carry_fields(tc))
    if surf is not None:
        S._pack_rows(state, [torch.from_numpy(surf["m"]),
                             *torch.from_numpy(surf["smooth_normal"]),
                             torch.from_numpy(surf["geometry_offset"])], S.SURF)
    return state


def _np(x):
    return np.asarray(x).reshape(-1)


def _close(got, ref, msg, exact=False):
    got, ref = _np(got), _np(ref)
    if got.dtype == bool or np.issubdtype(got.dtype, np.integer) or exact:
        np.testing.assert_array_equal(got, ref.astype(got.dtype), err_msg=msg)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6, err_msg=msg)


def _assert_carry(tc, jc, exact_color, what):
    for name in tpt.BounceCarry._fields:
        a, b = getattr(tc, name), getattr(jc, name)
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        for k, (x, y) in enumerate(zip(a, b)):
            _close(x.numpy(), y, f"{what}: {name}[{k}]",
                   exact=exact_color and name == "final_color")


REQ_FIELDS = (("ray_dir", S.Q_RAY_DIR, 3), ("smooth_normal", S.Q_SMOOTH_NORMAL, 3),
              ("sign_dir", S.Q_SIGN_DIR, 1), ("random_sphere", S.Q_RANDOM_SPHERE, 3),
              ("roughness_brdf", S.Q_ROUGHNESS_BRDF, 1), ("is_solid", S.Q_IS_SOLID, 1),
              ("write_id_w", S.Q_WRITE_ID_W, 1))
PICK_FIELDS = (("local_color", S.Q_LOCAL_COLOR, 3), ("res_num", S.Q_RES_NUM, 1),
               ("show_color", S.Q_SHOW_COLOR, 1), ("show_shadow", S.Q_SHOW_SHADOW, 1),
               ("offset_target", S.Q_OFFSET_TARGET, 3), ("light_dir", S.Q_LIGHT_DIR, 3),
               ("max_len", S.Q_MAX_LEN, 1))


def _assert_request(req, jreq, live):
    for owner, fields in ((jreq, REQ_FIELDS), (jreq.pick, PICK_FIELDS)):
        for name, row, width in fields:
            ref = getattr(owner, name)
            ref = ref if isinstance(ref, tuple) else (ref,)
            for k in range(width):
                _close(req[row + k].numpy()[live],
                       np.asarray(ref[k], np.float32).reshape(-1)[live], f"request {name}[{k}]")


CASES = [(kind, rng, i, False) for kind in ("shade", "interp_shade")
         for rng in ("counter", "hash") for i in (0, 1, 3)]
CASES += [(kind, "counter", i, True) for kind in ("shade", "interp_shade") for i in (1, 3)]


@pytest.mark.parametrize("kind,rng_mode,i,pallas", CASES)
def test_plain_shading_matches_flexlight_tpu(scene, reference_sin, exact_sqrt, monkeypatch, kind,
                                             rng_mode, i, pallas):
    jb, tb, mat = scene
    c, surf, tex, ndc, shadowed, hit = _inputs(100 + 10 * i + (rng_mode == "hash"),
                                               tb.id_buffer.numpy())
    cfg = port.Config(rng=rng_mode, max_reflections=5)
    seed, cos = 2.0, float(np.float32(np.cos(1.0)))
    jcarry, jreq, jtex, jshadow, jout = _jax_bounce(kind, jb, mat, c, surf, tex, ndc, i, cfg,
                                                    shadowed, hit, monkeypatch, pallas, seed,
                                                    cos)

    tc, _ = _carries(c)
    lights, cam = tb.lights.contiguous(), torch.tensor([0.5, 1.0, -14.0])
    seed_t, cos_t = torch.tensor(seed), torch.tensor(cos)
    ndc_t = torch.from_numpy(ndc)
    if kind == "shade":
        state = _port_state(tc, surf)
        req = torch.zeros((S.REQ_C, N))
        S.shade_plain(state, req, torch.from_numpy(tex), ndc_t, lights, cam, seed_t, cos_t, i,
                      cfg)
        live = surf["m"]
    else:
        state = _port_state(tc)
        req = torch.zeros((S.REQ_STEP_C, N))
        S.interp_shade_plain(state, req, ndc_t, mat, S.trivial_atlas(tb), lights, cam, seed_t,
                             cos_t, i, cfg)
        live = (state[S.SURF] > 0).numpy()
        _close(live, jreq.m, "m")
        _close(req[S.Q_EMIS].numpy()[live], _np(jtex[3])[live], "emis")
        for k in range(3):
            _close(req[S.Q_TPO + k].numpy()[live], _np(jtex[4][k])[live], f"tpo[{k}]")
    assert 0 < live.sum() < N
    # interpret mode runs the kernel body under jit, whose float rewrites
    # round otherwise than the op-by-op arithmetic (tests/test_torch_render.py)
    exact_color = rng_mode == "counter" and not pallas
    _assert_carry(carry_from_state(state), jcarry, exact_color, "carry after the kernel")
    _assert_request(req, jreq, live)

    # the whole bounce: the port's drop-in with the plain kernel, the same stubs
    cast = {}

    def shadow_soa(o3, d3, max_len, alive=None, bounce=False):
        cast["shadow"] = (o3, d3, max_len, alive)
        return torch.from_numpy(shadowed)

    def traverse_soa(o3, d3, alive=None, bounce=False):
        return tuple(torch.from_numpy(x) for x in hit)

    ndc2 = (ndc_t[0], ndc_t[1])
    if kind == "shade":
        fn = S.make_shade_bounce_post(tb, cam, cfg, PLAIN_SHADE)
        t = [torch.from_numpy(r) for r in tex]
        surface = tpt.BounceSurface(
            m=torch.from_numpy(surf["m"]),
            smooth_normal=_fields3(torch.from_numpy(surf["smooth_normal"])),
            geometry_offset=torch.from_numpy(surf["geometry_offset"]), bary_u=None,
            bary_v=None, tex_nums=None, inline_albedo=None, inline_rme=None, inline_tpo=None)
        out = fn(tc, surface, (tuple(t[0:3]), t[3], t[4], t[5], tuple(t[6:9])), i, tb, cam,
                 ndc2, cos_t, cfg, seed_t, traverse_soa, shadow_soa)
    else:
        fn = S.make_fused_bounce_step(tb, cam, cfg, PLAIN_SHADE)
        out = fn(tc, i, mat, ndc2, cos_t, seed_t, traverse_soa, shadow_soa)
    o3, d3, max_len, alive = cast["shadow"]
    jo3, jd3, jml, jalive = jshadow
    _close(alive.numpy(), jalive, "shadow alive")
    for name, x, y in (("offset_target", o3, jo3), ("light_dir", d3, jd3)):
        for k in range(3):
            _close(x[k].numpy()[live], _np(y[k])[live], f"shadow {name}[{k}]")
    _close(max_len.numpy()[live], _np(jml)[live], "shadow max_len")
    _assert_carry(out, jout, exact_color, "carry after the bounce")
