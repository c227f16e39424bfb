"""Guards of flexlight_tpu_torch: it never loads jax or flexlight_tpu, takes its device
explicitly and never falls back to a plain version on a device tensor,
chip_smoke.py refuses to run without a card, the ported surface raises
for what is not ported, and the transform-upload cache cannot be fooled
by a new registry."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from flexlight_tpu_torch import Config
from flexlight_tpu_torch.scene.transform import global_registry, reset_global_registry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)


def test_port_and_a_cpu_frame_never_import_jax():
    """Importing the port (with its frame server, runtime utilities and
    multi-device package) and rendering a CPU frame on the fused_split,
    kernel, mxu, clustered and fused schemes, a pipelined frame, a TAA
    frame, a frame of the default renderer (the rasterizer) and one of the
    simple renderer loads no module of jax and none of flexlight_tpu: the
    port keeps its own copy of what it uses."""
    code = """
import sys
import flexlight_tpu_torch as port
import flexlight_tpu_torch.serve
from flexlight_tpu_torch.utils import checkpoint, failover, glpack, image, settings, timing
from flexlight_tpu_torch.models.pathtracer import PathTracer
from flexlight_tpu_torch.scenes import stand_in_wood_texture, theater
e = theater(stand_in_wood_texture(0), device="cpu")
e.canvas = (16, 12)
e.config = port.Config(temporal=True, temporal_samples=2, filter=True, antialiasing="fxaa",
                       max_reflections=2)
e.renderer = "pathtracer"
img = e.renderer.render_frame()
assert img.shape == (12, 16, 3)
assert e.renderer.metrics.last["scheme"] == "fused_split"
e.renderer.pipelined = 2
assert e.renderer.render_frame_u8().shape == (12, 16, 3)
pt = PathTracer(16, 12, e.scene, e.camera, e.config, "cpu", scheme="kernel")
assert pt.render_frame().shape == (12, 16, 3)
for scheme in ("mxu", "clustered"):
    pt = PathTracer(16, 12, e.scene, e.camera, e.config, "cpu", scheme=scheme)
    assert pt.render_frame().shape == (12, 16, 3)
import flexlight_tpu_torch.parallel
from flexlight_tpu_torch.parallel import multihost, tile_sharding
from flexlight_tpu_torch.scenes import wave
w, animate = wave(device="cpu")
animate(0)
pt = PathTracer(16, 12, w.scene, w.camera, e.config, "cpu", scheme="fused")
assert pt.render_frame().shape == (12, 16, 3) and pt.metrics.last["scheme"] == "fused"
e.config = e.config.replace(antialiasing="taa")
e.renderer = "rasterizer"
assert e.renderer.render_frame().shape == (12, 16, 3)
assert e.renderer.metrics.last["scheme"] == "kernel" and e.renderer.metrics.last["layers"] == 4
e.renderer = "pathtracer"
assert e.renderer.render_frame().shape == (12, 16, 3)
e.api = "simple"
assert type(e.renderer).__name__ == "SimplePathTracer" and e.renderer.render_frame().shape == (12, 16, 3)
print("jax" in sys.modules, any(m.startswith("jax.") or m.startswith("jaxlib") for m in sys.modules),
      sorted(m for m in sys.modules if m == "flexlight_tpu" or m.startswith("flexlight_tpu.")))
"""
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["False", "False", "[]"]


def test_chip_smoke_fails_clearly_without_a_card(tmp_path):
    """Here there is no CUDA device: the script must exit non-zero, say
    why, and print no result line. Alone in a directory it fails too."""
    script = os.path.join(ROOT, "chip_smoke.py")
    for cwd in (ROOT, str(tmp_path)):
        if cwd != ROOT:
            (tmp_path / "chip_smoke.py").write_text(open(script).read())
        res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
                             text=True, timeout=300)
        assert res.returncode != 0
        assert "no CUDA device" in res.stdout
        assert '"ok"' not in res.stdout


def test_device_tensor_call_raises_instead_of_falling_back(monkeypatch):
    """A kernel wrapper given non-CPU tensors goes to the kernel library
    and raises when it cannot be had (no nvcc here); the plain version is
    never called."""
    from flexlight_tpu_torch import _native
    from flexlight_tpu_torch.kernels import KERNELS

    if _native._library is not None:
        pytest.skip("a kernel library is already loaded in this process")
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    for k in KERNELS:
        monkeypatch.setattr(k, "plain", lambda *a, **kw: pytest.fail("fell back to plain"))
    meta = torch.empty(4, device="meta")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        KERNELS.fxaa(torch.empty(2, 2, 4, device="meta"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        KERNELS.any_hit(torch.empty(4, 1, 16, device="meta"), (meta,) * 3, (meta,) * 3, meta)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        KERNELS.sp_post(torch.empty(55, 4, device="meta"), *(None,) * 11)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        KERNELS.fused_frame(torch.empty(3, 4, device="meta"), *(None,) * 13)
    assert all(k.launches == 0 for k in KERNELS)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    from flexlight_tpu_torch.kernels import KERNELS

    before = [k.launches for k in KERNELS]
    img = torch.rand(8, 8, 4)
    torch.testing.assert_close(KERNELS.fxaa(img), KERNELS.fxaa.plain(img))
    assert [k.launches for k in KERNELS] == before


def test_the_layers_below_the_renderers_never_import_them():
    """No module under flexlight_tpu_torch's ops/, post/ or parallel/
    imports its models/ (lazily inside a function neither), and the
    rasterizer does not import the path tracer's module: the kernel table
    (flexlight_tpu_torch.kernels), the post chain (post.chain) and the
    scheme rule (ops.pathtrace.resolve_scheme) sit below the renderers."""
    import ast
    import pathlib

    import flexlight_tpu_torch as port

    root = pathlib.Path(port.__file__).parent

    def imported(path):
        """The dotted names a module's import statements reach."""
        package = path.relative_to(root.parent).with_suffix("").parts[:-1]
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                yield from (alias.name for alias in node.names)
            elif isinstance(node, ast.ImportFrom):
                base = package[:len(package) + 1 - node.level] if node.level else ()
                module = ".".join(base + ((node.module,) if node.module else ()))
                yield module
                yield from (f"{module}.{alias.name}" for alias in node.names)

    models = f"{port.__name__}.models"
    below = [path for layer in ("ops", "post", "parallel")
             for path in sorted((root / layer).rglob("*.py"))]
    assert len(below) > 20
    wrong = [f"{path.relative_to(root)}: {name}" for path in below for name in imported(path)
             if name == models or name.startswith(models + ".")]
    assert not wrong, wrong
    raster = list(imported(root / "models" / "rasterizer.py"))
    assert f"{models}.base" in raster
    assert not [name for name in raster if name.startswith(f"{models}.pathtracer")], raster


def _engine(device="cpu"):
    """Cornell on the port's engine, built with the port's classes."""
    import flexlight_tpu_torch as port

    e = port.FlexLight((8, 8), device=device)
    reset_global_registry()
    e.scene = port.Scene()
    e.scene.primaryLightSources = [[0, 4, 0]]
    bottom = e.scene.Plane([-5, -5, -21], [5, -5, -21], [5, -5, 5], [-5, -5, 5])
    back = e.scene.Plane([-5, -5, 5], [5, -5, 5], [5, 5, 5], [-5, 5, 5])
    e.scene.queue.push([e.scene.Cuboid(-3, -1.5, -5, -2, -1, 1)], [bottom, back])
    e.camera = port.Camera()
    e.camera.z = -20
    e.config = Config(temporal=False, filter=False, antialiasing=None, max_reflections=1)
    return e


def test_unported_surface_raises():
    """Nothing of flexlight_tpu's surface stays unported: the mxu and
    clustered casts render on both renderers that take a scheme (they
    raised until they were ported; the test keeps its name), and so do
    the rasterizer and TAA. The device is an explicit argument. As in
    flexlight_tpu, only the path tracer has a pipelined fetch."""
    import flexlight_tpu_torch as port
    from flexlight_tpu_torch.models.pathtracer import PathTracer
    from flexlight_tpu_torch.models.rasterizer import Rasterizer

    with pytest.raises(TypeError):
        port.FlexLight((8, 8))  # the device is an explicit argument
    e = _engine()
    e.config = e.config.replace(antialiasing="taa")
    assert isinstance(e.renderer, Rasterizer)
    assert e.renderer.render_frame().shape == (8, 8, 3)
    e.renderer = "pathtracer"
    assert e.renderer.render_frame().shape == (8, 8, 3)
    assert hasattr(e.renderer, "pipelined")
    e.renderer = "rasterizer"
    assert not hasattr(e.renderer, "pipelined")
    e.api = "simple"
    assert not hasattr(e.renderer, "pipelined")
    for scheme in ("mxu", "clustered"):
        for cls in (PathTracer, Rasterizer):
            r = cls(8, 8, e.scene, e.camera, Config(), "cpu", scheme=scheme)
            img = r.render_frame()
            assert img.shape == (8, 8, 3) and np.isfinite(img).all() and img.max() > 0.0
            assert r.metrics.last["scheme"] == scheme
    with pytest.raises(ValueError, match="unknown scheme"):
        PathTracer(8, 8, e.scene, e.camera, Config(), "cpu", scheme="bvh").render_frame()


def test_transform_cache_survives_a_registry_reset():
    """The upload cache holds the registry object: a registry made after
    reset_global_registry(), at the same version, still uploads."""
    e = _engine()
    e.renderer = "pathtracer"
    r = e.renderer
    r.render_frame()
    reg = global_registry()
    assert r._transform_registry is reg
    reset_global_registry()
    fresh = global_registry()
    fresh.version = reg.version
    t = fresh.transform_list[0]
    t.move(1.0, 2.0, 3.0)
    fresh.version = reg.version
    r.render_frame()
    assert r._transform_registry is fresh
    np.testing.assert_array_equal(r._buffers.shifts[0, 0].numpy(), [1.0, 2.0, 3.0])


def test_u8_frames_and_light_updates():
    """render_frame_u8 is the rgba8 store of the frame; changed lights
    reach the buffers without re-flattening the scene."""
    e = _engine()
    e.renderer = "pathtracer"
    r = e.renderer
    f = r.render_frame()
    u8 = r.render_frame_u8()
    assert u8.dtype == np.uint8 and u8.shape == f.shape
    np.testing.assert_array_equal(u8, np.round(np.clip(f, 0, 1) * 255).astype(np.uint8))
    geometry = r._buffers.geometry
    e.scene.primary_light_sources[0].intensity = 7.0
    r.update_primary_light_sources()
    assert r._buffers.geometry is geometry
    assert float(r._buffers.lights[0, 1, 0]) == 7.0


def test_the_port_reads_no_flexlight_environment_variable(monkeypatch):
    """flexlight_tpu takes knobs from FLEXLIGHT_* environment variables at
    trace time (FLEXLIGHT_SHADE_KERNEL, FLEXLIGHT_FORCE_2D, ...); the port
    takes arguments (flexlight_tpu's FLEXLIGHT_FUSED_RAY_TILE of
    scheme="fused" has no counterpart). No module of flexlight_tpu_torch
    names such a variable outside its docstrings and comments, and CPU
    frames on every scheme, with the shading kernels' switch on and off,
    read none."""
    import ast
    import pathlib

    import flexlight_tpu_torch as port
    from flexlight_tpu_torch.models.pathtracer import PathTracer
    from flexlight_tpu_torch.models.rasterizer import Rasterizer
    from flexlight_tpu_torch.scenes import stand_in_wood_texture, theater, wave

    named = []
    for path in sorted(pathlib.Path(port.__file__).parent.rglob("*.py")):
        tree = ast.parse(path.read_text())
        docs = {id(node.body[0].value) for node in ast.walk(tree)
                if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                     ast.AsyncFunctionDef))
                and node.body and isinstance(node.body[0], ast.Expr)}
        named += [f"{path.name}:{node.lineno}" for node in ast.walk(tree)
                  if isinstance(node, ast.Constant) and isinstance(node.value, str)
                  and "FLEXLIGHT_" in node.value and id(node) not in docs]
    assert not named, named

    read = []

    class Recording(type(os.environ)):
        def __getitem__(self, key):
            read.append(key)
            return super().__getitem__(key)

        def get(self, key, default=None):
            read.append(key)
            return super().get(key, default)

        def __contains__(self, key):
            read.append(key)
            return super().__contains__(key)

    env = Recording(os.environ._data, os.environ.encodekey, os.environ.decodekey,
                    os.environ.encodevalue, os.environ.decodevalue)
    monkeypatch.setattr(os, "environ", env)
    monkeypatch.setattr(os, "getenv", env.get)
    e = theater(stand_in_wood_texture(0), device="cpu")
    cfg = Config(temporal=False, filter=False, antialiasing=None, max_reflections=2)
    for scheme, switch in (("auto", False), ("kernel", False), ("kernel", True),
                           ("sparse", False), ("sparse", True), ("scan", False)):
        PathTracer(8, 8, e.scene, e.camera, cfg, "cpu", scheme=scheme,
                   shade_kernel=switch).render_frame()
    for scheme in ("kernel", "sparse"):
        Rasterizer(8, 8, e.scene, e.camera, cfg, "cpu", scheme=scheme).render_frame()
    # scheme="fused" serves small atlases only: wave
    w, _ = wave(device="cpu")
    PathTracer(8, 8, w.scene, w.camera, cfg, "cpu", scheme="fused").render_frame()
    assert not [k for k in read if str(k).startswith("FLEXLIGHT_")], read
