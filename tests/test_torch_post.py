"""The port's post stack against flexlight_tpu on the same inputs: the
denoise passes (plain version of csrc/disc_filter.cu) against the gather
oracle post/filters.py and the packed Pallas kernels (interpret mode) in
compat and fast mode, the packed helpers, FXAA (plain version of
csrc/fxaa.cu) against post/fxaa.py and fxaa_tpu, the temporal ring, and
the filter chain's ping-pong indexing.

Tolerances: every pass stores rgba8, so agreement is exact up to the
order of the tap sums. The HDR fract/floor split (mod(x, 1) of a
~100-magnitude sum) turns a 1-ulp order difference into a one-step
(1/255) flip on isolated pixels: the bound is <= 1.5/255 on <= 2% of
values (tests/test_filter_kernel.py's budget), and 1e-4 on the unquantized
final pass elsewhere."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from flexlight_tpu.post import filter_kernel as JK  # noqa: E402
from flexlight_tpu.post import filters as JF  # noqa: E402
from flexlight_tpu.post.fxaa import fxaa as jfxaa  # noqa: E402
from flexlight_tpu.post import temporal as jtemp  # noqa: E402
from flexlight_tpu.post.fxaa_kernel import fxaa_tpu  # noqa: E402
from flexlight_tpu_torch.post import filter_kernel as TK  # noqa: E402
from flexlight_tpu_torch.post import filters as TF  # noqa: E402
from flexlight_tpu_torch.post import temporal as ttemp  # noqa: E402
from flexlight_tpu_torch.post.fxaa import fxaa as tfxaa  # noqa: E402

H, W = 32, 48


def _q(x):
    """rgba8 store values k * f32(1/255), as the renderer quantizes."""
    return (np.round(np.clip(x, 0, 1) * 255).astype(np.float32) * np.float32(1 / 255))


@pytest.fixture(scope="module")
def imgs():
    """(color, ip, ocolor, ids, oid) [H, W, 4] quantized, with id regions,
    shadow/light id bytes, glass-ish ip.w and a half-zero blur key."""
    rng = np.random.default_rng(7)
    ids = _q(rng.uniform(0, 1, (6, 4)))[rng.integers(0, 6, (H, W))]
    oid = _q(rng.uniform(0, 1, (4, 4)))[rng.integers(0, 4, (H, W))]
    color = _q(rng.uniform(0, 1, (H, W, 4)))
    ip = _q(np.where(rng.uniform(size=(H, W, 4)) < 0.3, rng.uniform(0, 0.3, (H, W, 4)), 0))
    ocw = _q(np.where(rng.uniform(size=(H, W)) < 0.5, rng.uniform(0, 1, (H, W)), 0))
    ocolor = np.concatenate([_q(rng.uniform(0, 1, (H, W, 3))), ocw[..., None]], -1)
    return tuple(x.astype(np.float32) for x in (color, ip, ocolor, ids, oid))


def _check(ref, got, budget=0.02):
    for a, b in zip(ref, got):
        d = np.abs(np.asarray(a, dtype=np.float32) - np.asarray(b, dtype=np.float32))
        assert float(d.max()) <= 1.5 / 255.0, d.max()
        assert float((d > 1e-4).mean()) <= budget, (d > 1e-4).mean()


def _t(xs):
    return tuple(torch.from_numpy(x) for x in xs)


def _j(xs):
    return tuple(jnp.asarray(x) for x in xs)


def test_vote_repair_matches_exactly(imgs):
    ref = JF.vote_repair(*_j(imgs))
    got = TF.vote_repair(*_t(imgs))
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_vote_repair_packed_matches_exactly(imgs):
    color, ip, ocolor, ids, oid = imgs
    ref = JK.vote_repair_packed(JK.pack_rgba8(jnp.asarray(ids)), JK.pack_rgba8(jnp.asarray(oid)),
                                jnp.asarray(ip[..., 3]))
    got = TK.vote_repair_packed(TK.pack_rgba8(torch.from_numpy(ids)),
                                TK.pack_rgba8(torch.from_numpy(oid)), torch.from_numpy(ip[..., 3]))
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_pack_and_tileize_match_exactly(imgs):
    ocolor = imgs[2]
    jp, tp = JK.pack_rgba8(jnp.asarray(ocolor)), TK.pack_rgba8(torch.from_numpy(ocolor))
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    np.testing.assert_array_equal(TK.unpack_rgba8(tp).numpy(), ocolor)
    np.testing.assert_array_equal(np.asarray(JK.tileize_blur_key_packed(jp, ty=8, tx=16)),
                                  TK.tileize_blur_key_packed(tp, ty=8, tx=16).numpy())


@pytest.mark.parametrize("name", ["first_filter", "second_filter", "final_filter"])
def test_filter_pass_matches_gather_oracle(imgs, name):
    extra = (True,) if name == "final_filter" else ()
    ref = getattr(JF, name)(*_j(imgs), *extra)
    got = getattr(TF, name)(*_t(imgs), *extra)
    if name == "final_filter":
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
    else:
        _check(ref, [g.numpy() for g in got])


def _packed(imgs, fast):
    """The five packed planes in argument order (color, ip, ocolor, ids,
    oid), with the fast mode's tileized blur key."""
    planes = [TK.pack_rgba8(torch.from_numpy(x)) for x in imgs]
    if fast:
        planes[2] = TK.tileize_blur_key_packed(planes[2])
    return planes


@pytest.mark.parametrize("mode", ["compat", "fast"])
def test_first_pass_in_both_modes_matches_gather_oracle(imgs, mode):
    """The first pass as the chain runs it: on packed planes, with the
    fast mode's tileized blur key, against the gather oracle on the same
    (unpacked) inputs. flexlight_tpu's own tests pin its packed Pallas
    first pass to that oracle (tests/test_filter_kernel.py); interpreting
    its 705-offset kernel here would cost a minute."""
    tp = _packed(imgs, mode == "fast")
    ref = JF.first_filter(*(jnp.asarray(TK.unpack_rgba8(p).numpy()) for p in tp))
    got = TK.first_filter_packed(*tp)
    _check(ref, [TK.unpack_rgba8(g).numpy() for g in got])


@pytest.mark.parametrize("mode,which", [("compat", "final"), ("fast", "second")])
def test_packed_pass_matches_pallas_kernel(imgs, mode, which):
    """The port's packed pass (its plain version on CPU) against the JAX
    packed Pallas kernel in interpret mode, called as each mode's chain
    calls it (post/chain.py filter_chain_packed), on a 16x24 crop
    to bound the interpreter's time."""
    tp = [p[:16, :24].contiguous() for p in _packed(imgs, mode == "fast")]
    jp = [jnp.asarray(p.numpy()) for p in tp]
    kw = dict(ty=64, compact=True) if mode == "fast" else {}
    if which == "final":
        ref = JK.final_filter_tpu_packed(*jp, True, interpret=True, **kw)
        got = TK.final_filter_packed(*tp, True)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
    else:
        ref = JK.second_filter_tpu_packed(*jp, interpret=True, **kw)
        got = TK.second_filter_packed(*tp)
        unpack = lambda p: TK.unpack_rgba8(torch.as_tensor(np.array(p))).numpy()
        _check([unpack(a) for a in ref], [unpack(b) for b in got])


def _aa_input(seed, blocky):
    rng = np.random.default_rng(seed)
    if blocky:
        img = np.kron(rng.uniform(0, 1, (H // 8, W // 8, 4)), np.ones((8, 8, 1)))
    else:
        img = rng.uniform(0, 1, (H, W, 4))
    img[..., 3] = (img[..., 3] > 0.2).astype(np.float64)
    return img.astype(np.float32)


@pytest.mark.parametrize("blocky", [False, True])
def test_fxaa_matches_oracle_and_kernel(blocky):
    """Same expressions in the same order as post/fxaa.py: 1e-6. Against
    the prefix-form Pallas kernel, float associativity decides exact span
    ties (edge_horz == edge_vert) either way, so the budget is
    tests/test_fxaa_kernel.py's: <= 3% of pixels over 3e-6."""
    img = _aa_input(5, blocky)
    got = tfxaa(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, np.asarray(jfxaa(jnp.asarray(img))), atol=1e-6)
    ref = np.asarray(fxaa_tpu(jnp.asarray(img), interpret=True))
    assert (np.abs(got - ref).max(axis=-1) > 3e-6).mean() <= 0.03


def test_temporal_ring_matches_exactly(imgs):
    rng = np.random.default_rng(9)
    frames = [tuple(_q(rng.integers(0, 3, (H, W, 4)) / 2.0).astype(np.float32)
                    for _ in range(4)) for _ in range(3)]
    js = jtemp.TemporalState.create(4, H, W)
    ts = ttemp.TemporalState.create(4, H, W, "cpu")
    for f in frames:
        js = jtemp.push_frame(js, *_j(f))
        ts = ttemp.push_frame(ts, *_t(f))
        for a, b in zip(jtemp.temporal_average(js), ttemp.temporal_average(ts)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("passes", [(3, 3), (2, 3), (3, 2)])
def test_filter_chain_index_pattern_matches(monkeypatch, passes):
    """filter_chain_packed's ping-pong and dropped-attachment indexing
    (post/chain.py): every pass replaced by a stub that
    tags its outputs, both chains must feed every pass, and the final one,
    the same tagged inputs."""
    from flexlight_tpu import Config
    from flexlight_tpu.models import pathtracer as jpt
    from flexlight_tpu_torch.post import chain as tpt

    def stubs(mod, as_array):
        log, counter = [], [100]

        def tag(x):
            return int(np.asarray(x).reshape(-1)[0])

        def fresh():
            counter[0] += 1
            return as_array(counter[0])

        def first(*xs, **kw):
            log.append(("first", tuple(tag(x) for x in xs)))
            return fresh(), fresh(), fresh()

        def second(*xs, **kw):
            log.append(("second", tuple(tag(x) for x in xs)))
            return fresh(), fresh(), fresh()

        def final(*xs, **kw):
            log.append(("final", tuple(tag(x) for x in xs[:5])))
            return xs[0]

        return log, first, second, final

    cfg = Config(first_passes=passes[0], second_passes=passes[1], filter_mode="compat")
    jlog, f1, f2, f3 = stubs(JK, lambda v: jnp.full((2, 2), v, jnp.int32))
    monkeypatch.setattr(JK, "first_filter_tpu_packed", f1)
    monkeypatch.setattr(JK, "second_filter_tpu_packed", f2)
    monkeypatch.setattr(JK, "final_filter_tpu_packed", f3)
    monkeypatch.setattr(JK, "pack_rgba8", lambda x: jnp.asarray(x, jnp.int32)[..., 0])
    tlog, g1, g2, g3 = stubs(TK, lambda v: torch.full((2, 2), v, dtype=torch.int32))
    monkeypatch.setattr(tpt, "first_filter_packed", g1)
    monkeypatch.setattr(tpt, "second_filter_packed", g2)
    monkeypatch.setattr(tpt, "final_filter_packed", g3)
    monkeypatch.setattr(tpt, "pack_rgba8", lambda x: torch.as_tensor(x)[..., 0].to(torch.int32))
    inputs = [np.full((2, 2, 4), v, np.float32) for v in (1, 2, 3, 4, 5)]
    jpt._filter_chain_packed(cfg, *[jnp.asarray(x) for x in inputs])
    tpt.filter_chain_packed(cfg, *[torch.from_numpy(x) for x in inputs])
    assert tlog == jlog
    assert len(tlog) == sum(passes) + 1
