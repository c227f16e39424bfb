"""The CUDA kernels on the card: each kernel wrapper on CUDA tensors
against its plain version on the same tensors, and a small theater frame
through all of them. Marked `gpu`; without a CUDA device these tests skip.
Run on a machine with a card:

    python -m pytest -m gpu tests/test_torch_cuda.py

Expected agreement is bit for bit (the kernels take the plain versions'
operations in the same order, built without FMA contraction), except the
final pass and FXAA, whose few divisions by constants torch may round
differently on the card (1e-5)."""

import numpy as np
import pytest
import torch

from flexlight_tpu import Config

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.fixture(scope="module")
def frame(dev):
    """One 96x64 theater frame with the plain versions, recording each
    kernel's first inputs; and the frame itself."""
    from flexlight_tpu_torch.models.pathtracer import PLAIN, KernelSet, PathTracer
    from flexlight_tpu_torch.scenes import stand_in_wood_texture, theater

    captured = {}

    def recorder(name, fn):
        def rec(*a):
            captured.setdefault(name, a)
            return fn(*a)
        return rec

    kernels = KernelSet(*(recorder(n, f) for n, f in zip(KernelSet._fields, PLAIN)))
    e = theater(stand_in_wood_texture(0), device=dev)
    cfg = Config(temporal=True, temporal_samples=4, filter=True, antialiasing="fxaa",
                 samples_per_ray=1, max_reflections=5)
    img = PathTracer(96, 64, e.scene, e.camera, cfg, dev, kernels=kernels).render_frame()
    return captured, img, e, cfg


@pytest.mark.parametrize("name", ["closest_hit", "any_hit", "first_blur", "second_blur",
                                  "final_blur", "fxaa"])
def test_kernel_matches_plain_on_the_card(frame, name):
    from flexlight_tpu_torch.models.pathtracer import KERNELS, PLAIN

    captured = frame[0]
    kernel = getattr(KERNELS, name)
    before = kernel.launches
    got = kernel(*captured[name])
    ref = getattr(PLAIN, name)(*captured[name])
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for a, b in zip(got, ref):
        assert a.is_cuda and a.dtype == b.dtype and a.shape == b.shape
        if a.dtype.is_floating_point:
            torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
        else:
            assert torch.equal(a, b)


def test_frame_through_the_kernels_matches_the_plain_frame(frame, dev):
    from flexlight_tpu_torch.models.pathtracer import KERNELS, PathTracer

    _, plain_img, e, cfg = frame
    counts = [k.launches for k in KERNELS]
    img = PathTracer(96, 64, e.scene, e.camera, cfg, dev).render_frame()
    assert all(k.launches > c for k, c in zip(KERNELS, counts))
    assert img.shape == (64, 96, 3) and np.isfinite(img).all() and img.max() > 0
    d = np.abs(img - plain_img)
    assert (d > 2e-3).mean() <= 0.01 and d.max() <= 0.5
