"""The port's own copy of the jax-free host layer (scene graph, camera,
config, transforms, flattening) against flexlight_tpu's: each package
builds the same scene with its own classes, and both flatten to identical
buffers. Exact equality: the copies run the same numpy code.

The builders here (`build`) are what the other port tests use to put the
same scene into both packages."""

import importlib
import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import flexlight_tpu as jpkg  # noqa: E402
from flexlight_tpu.ops import buffers as jbuf  # noqa: E402
from flexlight_tpu.scene import transform as jtransform  # noqa: E402
import flexlight_tpu_torch as port  # noqa: E402
from flexlight_tpu_torch.ops import buffers as tbuf  # noqa: E402
from flexlight_tpu_torch.scene import transform as ttransform  # noqa: E402
from flexlight_tpu_torch.native import available as native_available  # noqa: E402
from flexlight_tpu_torch.scene.static_mesh import StaticMesh  # noqa: E402
from flexlight_tpu_torch.scenes import stand_in_wood_data, theater  # noqa: E402

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
SCENES = ("cornell", "theater", "example2", "wave")


def _cornell(pkg):
    """tests/scenes.py:cornell_scene on `pkg`'s Scene and Camera."""
    scene = pkg.Scene()
    scene.primaryLightSources = [[0, 4, 0]]
    scene.primary_light_sources[0].intensity = 160
    bottom = scene.Plane([-5, -5, -21], [5, -5, -21], [5, -5, 5], [-5, -5, 5])
    top = scene.Plane([-5, 5, -21], [-5, 5, 5], [5, 5, 5], [5, 5, -21])
    back = scene.Plane([-5, -5, 5], [5, -5, 5], [5, 5, 5], [-5, 5, 5])
    front = scene.Plane([-5, -5, -21], [-5, 5, -21], [5, 5, -21], [5, -5, -21])
    left = scene.Plane([-5, -5, -21], [-5, -5, 5], [-5, 5, 5], [-5, 5, -21])
    right = scene.Plane([5, -5, -21], [5, 5, -21], [5, 5, 5], [5, -5, 5])
    for plane in [bottom, top, back, front, left, right]:
        plane.color = [230, 230, 230]
    left.color = [220, 0, 0]
    right.color = [0, 150, 0]
    cube0 = scene.Cuboid(-3, -1.5, -5, -2, -1, 1)
    cube1 = scene.Cuboid(0, 3, -5, -1, -1, 2)
    scene.queue.push([cube0, cube1], [bottom, top, back, front, left, right])
    camera = pkg.Camera()
    camera.z = -20
    return scene, camera


def _engine(pkg):
    if pkg is port:
        return port.FlexLight((192, 192), device="cpu")
    return jpkg.FlexLight((192, 192))


def _example(name, pkg):
    """examples/<name>.py:build_scene on `pkg`'s FlexLight (the examples
    that load no asset: example2, emissive, wave)."""
    sys.path.insert(0, EXAMPLES)
    try:
        module = importlib.import_module(name)
    finally:
        sys.path.remove(EXAMPLES)
    saved = module.FlexLight
    module.FlexLight = lambda canvas: _engine(pkg)
    try:
        engine = module.build_scene()
    finally:
        module.FlexLight = saved
    engine = engine[0] if isinstance(engine, tuple) else engine
    return engine.scene, engine.camera


def build(name, pkg):
    """(scene, camera) of `name` made with `pkg`'s classes (`pkg` is
    flexlight_tpu or flexlight_tpu_torch), after resetting that package's
    transform registry."""
    (ttransform if pkg is port else jtransform).reset_global_registry()
    if name == "cornell":
        return _cornell(pkg)
    if name == "theater":
        e = theater(pkg.Texture(stand_in_wood_data(0)), engine=_engine(pkg))
        return e.scene, e.camera
    if name in ("example2", "emissive", "wave"):
        return _example(name, pkg)
    raise ValueError(name)


def both_buffers(name):
    """The scene `name` built and flattened by each package: (flexlight_tpu
    SceneBuffers, port SceneBuffers on the CPU, port camera)."""
    jscene, _ = build(name, jpkg)
    jb = jbuf.build_scene_buffers(jscene)
    tscene, tcamera = build(name, port)
    tb = tbuf.build_scene_buffers(tscene, "cpu")
    return jb, tb, tcamera


def assert_same_buffers(jb, tb):
    for field in tbuf.SceneBuffers._fields:
        a, b = getattr(jb, field), getattr(tb, field)
        if field.endswith("_tab"):
            for k in tbuf.AtlasTable._fields:
                x, y = np.asarray(getattr(a, k)), getattr(b, k).numpy()
                assert x.dtype == y.dtype and x.shape == y.shape, (field, k)
                np.testing.assert_array_equal(y, x, err_msg=f"{field}.{k}")
        else:
            x, y = np.asarray(a), b.numpy()
            assert x.dtype == y.dtype and x.shape == y.shape, field
            np.testing.assert_array_equal(y, x, err_msg=field)


@pytest.mark.parametrize("name", SCENES)
def test_scene_copies_flatten_to_identical_buffers(name):
    jb, tb, _ = both_buffers(name)
    assert_same_buffers(jb, tb)
    assert tb.id_buffer.shape[0] > 0 and tb.lights.shape[0] > 0


@pytest.mark.parametrize("name", SCENES)
def test_scenes_register_in_their_own_package(name):
    """A scene made from the port's classes registers its transforms in the
    port's registry and leaves flexlight_tpu's alone."""
    jtransform.reset_global_registry()
    before = jtransform.global_registry().count
    build(name, port)
    t = ttransform.Transform()
    assert t.registry is ttransform.global_registry()
    assert ttransform.global_registry().count >= 2
    assert jtransform.global_registry().count == before


def test_cameras_and_configs_agree():
    jscene, jcam = build("theater", jpkg)
    tscene, tcam = build("theater", port)
    for w, h in ((192, 192), (1920, 1080)):
        np.testing.assert_array_equal(tcam.view_matrix(w, h), jcam.view_matrix(w, h))
    np.testing.assert_array_equal(tcam.position, jcam.position)
    assert [f.name for f in port.Config.__dataclass_fields__.values()] == \
        [f.name for f in jpkg.Config.__dataclass_fields__.values()]
    assert port.Config() == port.Config(**vars(jpkg.Config()))


_OBJ = """v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0 0 1
vt 0 0
vt 1 0
vt 1 1
vn 0 0 1
f 1/1/1 2/2/1 3/3/1 4/1/1
f 1/1/1 2/2/1 5/3/1
"""


def test_import_obj_pure_python_path_and_fast_path_refusal(tmp_path, monkeypatch):
    """fast=False takes the pure-Python parser in both packages; where the
    native loader cannot be built, fast=None falls back to the parser and
    fast=True raises."""
    from flexlight_tpu_torch import native

    path = tmp_path / "quad_tri.obj"
    path.write_text(_OBJ)
    ttransform.reset_global_registry()
    jtransform.reset_global_registry()
    tscene, jscene = port.Scene(), jpkg.Scene()
    tscene.queue.push(tscene.import_obj(str(path), fast=False))
    jscene.queue.push(jscene.import_obj(str(path), fast=False))
    assert_same_buffers(jbuf.build_scene_buffers(jscene),
                        tbuf.build_scene_buffers(tscene, "cpu"))
    monkeypatch.setattr(native, "available", lambda: False)
    assert not isinstance(tscene.import_obj(str(path)), StaticMesh)
    with pytest.raises(RuntimeError, match="native loader"):
        tscene.import_obj(str(path), fast=True)


@pytest.mark.skipif(not native_available(), reason="no host C++ compiler for the OBJ loader")
@pytest.mark.parametrize("fast", [None, True])
def test_native_obj_loader_matches_the_jax_package(tmp_path, fast):
    """The native loader and StaticMesh (the default route of import_obj in
    both packages): the seeded stand-in OBJ alone, and the whole dragon
    stand-in scene, flatten to identical buffers in both packages; the
    port's loader builds under build/, not in the package."""
    from flexlight_tpu_torch import native
    from flexlight_tpu_torch.scenes import dragon, dragon_stand_in_objs

    objs = dragon_stand_in_objs(0, tmp_path / "objects")
    ttransform.reset_global_registry()
    jtransform.reset_global_registry()
    tscene, jscene = port.Scene(), jpkg.Scene()
    tmesh = tscene.import_obj(objs["monke_smooth.obj"], fast=fast)
    assert isinstance(tmesh, StaticMesh)
    tscene.queue.push(tmesh)
    jscene.queue.push(jscene.import_obj(objs["monke_smooth.obj"], fast=fast))
    assert_same_buffers(jbuf.build_scene_buffers(jscene),
                        tbuf.build_scene_buffers(tscene, "cpu"))
    assert native.BUILD_ROOT.parts[-2:] == ("build", "flexlight_native")
    assert not list(native.SRC.parent.glob("*.so"))

    ttransform.reset_global_registry()
    jtransform.reset_global_registry()
    teng, _ = dragon(0, tmp_path / "port", device="cpu", fast=fast)
    jeng, _ = dragon(0, tmp_path / "jax", engine=jpkg.FlexLight((192, 192)), fast=fast)
    assert_same_buffers(jeng.renderer._buffers, teng.renderer._buffers)
    assert teng.renderer._buffers.id_buffer.shape[0] == 44890


def test_engine_facade_is_the_ports_own():
    e = port.FlexLight((8, 6), device="cpu")
    assert not isinstance(e, jpkg.FlexLight)
    assert isinstance(e.scene, port.Scene) and isinstance(e.camera, port.Camera)
    assert isinstance(e.config, port.Config) and e.device == torch.device("cpu")
    e.renderer = "pathtracer"
    r = e.renderer
    assert (r.width, r.height) == (8, 6) and r.device == torch.device("cpu")
    e.config = e.config.replace(max_reflections=2)
    assert r.config.max_reflections == 2
    e.canvas = (4, 4)
    assert e.renderer is not r and e.renderer.width == 4
    assert e.ui.scene is e.scene and e.io.camera is e.camera
