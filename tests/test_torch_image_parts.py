"""The frame server's PNG encode in row parts (utils.image.png_bytes_parts
and its part count png_parts) against the serial png_bytes: one part gives
png_bytes's bytes; more parts give one IDAT each, the same inflated stream,
the same pixels through the benchmark's decoder (portbench/png.py), sound
chunk CRCs and adler32, and a size within 1% of png_bytes's."""

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from flexlight_tpu_torch.utils import image
from portbench import png as bench_png


@pytest.fixture(scope="module")
def pool():
    with ThreadPoolExecutor(image.MAX_PNG_PARTS) as p:
        yield p


def chunks(data: bytes):
    """(tag, body) of every chunk of a PNG, each chunk's crc32 checked."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, out = 8, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF, tag
        out.append((tag, body))
        pos += 12 + n
    assert pos == len(data) and out[-1] == (b"IEND", b"")
    return out


def smooth(h, w, seed=0):
    """A smooth image with a little noise, as a rendered frame is."""
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([np.sin(x / 90.0), np.cos(y / 70.0), np.sin((x + y) / 130.0)], -1) * 0.5 + 0.5
    return img + np.random.default_rng(seed).normal(0.0, 0.02, img.shape)


@pytest.mark.parametrize("shape, level, dtype", [
    ((24, 24, 3), 1, np.uint8), ((256, 256, 3), 1, np.uint8),
    ((17, 5, 3), 6, np.float32), ((1, 33, 3), 9, np.uint8)])
def test_one_part_is_png_bytes(pool, shape, level, dtype):
    rng = np.random.default_rng(sum(shape) + level)
    img = (rng.uniform(-0.2, 1.2, shape).astype(np.float32) if dtype == np.float32
           else rng.integers(0, 256, shape, dtype=np.uint8))
    assert image.png_bytes_parts(img, 1, pool, level=level) == image.png_bytes(img, level=level)


@pytest.mark.parametrize("shape, parts", [
    ((270, 480, 3), 4), ((203, 64, 3), 3), ((130, 20, 3), 2), ((1, 33, 3), 1)])
def test_parts_are_one_stream_of_the_same_rows(pool, shape, parts):
    img = np.random.default_rng(parts).integers(0, 256, shape, dtype=np.uint8)
    data = image.png_bytes_parts(img, parts, pool, level=1)
    idat = [body for tag, body in chunks(data) if tag == b"IDAT"]
    assert len(idat) == parts
    stream = b"".join(idat)
    serial = b"".join(body for tag, body in chunks(image.png_bytes(img, level=1))
                      if tag == b"IDAT")
    assert stream[:2] == serial[:2]                      # zlib header of level 1
    raw = zlib.decompress(stream)                         # checks the adler32 too
    assert raw == zlib.decompress(serial)
    assert stream[-4:] == struct.pack(">I", zlib.adler32(raw))
    np.testing.assert_array_equal(bench_png.decode(data), img)


def test_parts_keep_the_size(pool):
    img = image.to_uint8(smooth(540, 960))
    serial = len(image.png_bytes(img, level=1))
    data = image.png_bytes_parts(img, 8, pool, level=1)
    assert sum(tag == b"IDAT" for tag, _ in chunks(data)) == 8
    assert abs(len(data) - serial) <= 0.01 * serial
    np.testing.assert_array_equal(bench_png.decode(data), img)


@pytest.mark.parametrize("height, cpus, parts", [
    (1080, 8, 7), (1080, 64, 16), (1080, 1, 1), (1080, 2, 1), (256, 8, 4),
    (24, 8, 1), (1, 8, 1), (127, 32, 1), (128, 32, 2)])
def test_png_parts_follows_height_and_cpus(monkeypatch, height, cpus, parts):
    monkeypatch.setattr(image.os, "sched_getaffinity", lambda pid: set(range(cpus)))
    assert image.png_parts(height) == parts
