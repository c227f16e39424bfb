"""The disc-denoise passes (csrc/disc_filter.cu: tiles staged in shared
memory, the taps gated on ID and OID first, the five packed planes read
directly), compiled for the host (-DFL_EMULATE: a block of one thread
takes its whole tile), against their plain versions (post/filter_kernel.py
*_blur_plain, the gather form of post/filters.py).

`disc_planes` makes the five packed planes of an H x W frame whose 32 x 128
key tiles take, in turn, the key 255 (the first pass's 42-px reach), the
key 0 (no blur) and per-pixel keys with zeros among them; IDs and OIDs in
patches, with glass OIDs (byte 3 above 0.1) and IP weights in some, so
that both the plain id gates and the glass gates of the second and final
passes decide taps. The sizes are no multiples of the kernels' tiles, so
taps leave the image, and in filter_mode "exact" (per-pixel keys) a first
pass's pixels with another key than their block's read their taps outside
the staged bands; "fast" tiles the key as the chain does
(tileize_blur_key_packed). The first and second passes must be identical to
their plain versions, the final pass within 1e-6 (the host's powf against
torch's pow in the gamma curve). The `gpu` twins of these cases are in
tests/test_torch_cuda.py."""

import shutil

import numpy as np
import pytest
import torch

from flexlight_tpu_torch import _native
from flexlight_tpu_torch.post import filter_kernel as FK

SIZES = ((96, 160), (70, 150))


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler for the emulated kernel build")
    return _native.build_library(tmp_path_factory.mktemp("kernels"), emulate=True)


def disc_planes(seed, h, w, mode, device="cpu"):
    """(ID, OID, COLOR, IP, OCOLOR) packed int32 [h, w] planes (see the
    module docstring); `mode` "fast" tiles the OCOLOR key."""
    rng = np.random.default_rng(seed)

    def patches(values, size):
        """values[i] [k, 4] bytes, picked per size x size patch."""
        py, px = -(-h // size), -(-w // size)
        pick = rng.integers(0, len(values), (py, px))
        return np.kron(pick, np.ones((size, size), np.int64))[:h, :w]

    ids = rng.integers(0, 256, (4, 4))
    ids = ids[patches(ids, 6)]
    oid = np.array([[9, 9, 9, 0], [20, 30, 40, 12], [20, 30, 40, 200], [5, 6, 7, 100]])
    oid = oid[patches(oid, 10)]
    color = rng.integers(0, 256, (h, w, 4))
    color[..., 3] = np.where(rng.uniform(size=(h, w)) < 0.1, 0, color[..., 3])
    ip = np.where(rng.uniform(size=(h, w, 4)) < 0.3, rng.integers(0, 60, (h, w, 4)), 0)
    ip[..., 3] = np.where(rng.uniform(size=(h, w)) < 0.5, 0, rng.integers(0, 256, (h, w)))
    ocolor = rng.integers(0, 256, (h, w, 4))
    tile = (np.arange(h)[:, None] // 32 + np.arange(w)[None, :] // 128) % 3
    per_pixel = np.where(rng.uniform(size=(h, w)) < 0.3, 0, rng.integers(1, 256, (h, w)))
    ocolor[..., 3] = np.select([tile == 0, tile == 1], [255, 0], per_pixel)
    planes = [FK.pack_rgba8(torch.from_numpy(x.astype(np.float32) / 255.0))
              for x in (ids, oid, color, ip, ocolor)]
    if mode == "fast":
        planes[4] = FK.tileize_blur_key_packed(planes[4])
    return tuple(p.to(device) for p in planes)


@pytest.mark.parametrize("mode", ["fast", "exact"])
@pytest.mark.parametrize("size", SIZES)
def test_the_planes_cover_the_cases(size, mode):
    """Key tiles of 255 and 0 and (exact) per-pixel keys; glass OIDs."""
    planes = disc_planes(0, *size, mode)
    key = FK.byte_i(planes[4], 3)
    assert bool((key[:32, :128] == 255).all()) and bool((key[:32, 128:] == 0).all())
    rest = key[64:, :128]
    assert (rest.unique().numel() > 20) == (mode == "exact") and bool((rest > 0).any())
    oidw = FK.byte_i(planes[1], 3)
    assert bool((oidw > 25).any()) and bool((oidw == 0).any())


@pytest.mark.parametrize("mode", ["fast", "exact"])
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("which", ["first", "second"])
def test_disc_pass_is_bit_exact_on_mixed_key_tiles(lib, which, size, mode):
    planes = disc_planes(1, *size, mode)
    got = getattr(FK, f"_{which}_blur_launch")(lib, 0, *planes)
    ref = getattr(FK, f"{which}_blur_plain")(*planes)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.parametrize("mode", ["fast", "exact"])
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("hdr", [True, False])
def test_final_pass_matches_on_mixed_key_tiles(lib, hdr, size, mode):
    planes = disc_planes(2, *size, mode)
    got = FK._final_blur_launch(lib, 0, *planes, hdr)
    ref = FK.final_blur_plain(*planes, hdr)
    assert got.shape == ref.shape == (*size, 3)
    torch.testing.assert_close(got, ref, atol=1e-6, rtol=0)
