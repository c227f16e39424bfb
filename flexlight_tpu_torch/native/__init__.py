"""ctypes bindings for the native host runtime (OBJ loader and BVH construction).

The port's own copy of flexlight_tpu/native (flexlight_tpu_torch imports
nothing of the JAX package). The C++ source is compiled at first use with
g++ into the checkout's git-ignored build tree
(``build/flexlight_native/<hash>/``, keyed on a hash of the source and the
flags), never into the package directory. Where no compiler is found or the
build fails, `available()` is False and `import_obj` takes the pure-Python
parser (or raises, if the caller asked for this loader).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "flexlight_native.cpp"
BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build" / "flexlight_native"
FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17")
LIB_NAME = "libflexlight_native.so"

_lock = threading.Lock()
_lib = None
_tried = False


def _build(build_root: Path = BUILD_ROOT) -> Path | None:
    """Compile the source once per content hash; the library's path, or
    None when there is no compiler or the build fails."""
    compiler = shutil.which("g++") or shutil.which("c++")
    if compiler is None:
        return None
    key = hashlib.sha256(SRC.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    out_dir = Path(build_root) / key
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    try:
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f".{LIB_NAME}.{os.getpid()}"
        subprocess.run([compiler, *FLAGS, str(SRC), "-o", str(tmp)], check=True,
                       capture_output=True, timeout=600)
        os.replace(tmp, lib_path)
    except (OSError, subprocess.SubprocessError):
        return None
    return lib_path


def get_lib():
    """The loaded native library, or None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        lib = ctypes.CDLL(str(path))
        lib.fl_load_obj.restype = ctypes.c_void_p
        lib.fl_load_obj.argtypes = [ctypes.c_char_p]
        lib.fl_num_tris.restype = ctypes.c_int64
        lib.fl_num_tris.argtypes = [ctypes.c_void_p]
        lib.fl_num_slots.restype = ctypes.c_int64
        lib.fl_num_slots.argtypes = [ctypes.c_void_p]
        lib.fl_material_names.restype = ctypes.c_char_p
        lib.fl_material_names.argtypes = [ctypes.c_void_p]
        lib.fl_copy_tris.restype = None
        lib.fl_copy_tris.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 4
        lib.fl_copy_stream.restype = None
        lib.fl_copy_stream.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 4
        lib.fl_release.restype = None
        lib.fl_release.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


class ObjData:
    """Parsed OBJ + flattened BVH stream from the native loader."""

    def __init__(self, verts, normals, uvs, mats, material_names,
                 kind, aabb, skip, tri_index):
        self.verts = verts              # [T, 9] f32
        self.normals = normals          # [T, 9] f32
        self.uvs = uvs                  # [T, 6] f32
        self.mats = mats                # [T] int32 material index (-1 none)
        self.material_names = material_names
        self.kind = kind                # [S] int32 (1 node, 2 triangle)
        self.aabb = aabb                # [S, 6] f32
        self.skip = skip                # [S] int32
        self.tri_index = tri_index      # [S] int32 (-1 for nodes)


def load_obj(path: str) -> ObjData | None:
    lib = get_lib()
    if lib is None:
        return None
    handle = lib.fl_load_obj(str(path).encode())
    if not handle:
        raise FileNotFoundError(path)
    try:
        t = lib.fl_num_tris(handle)
        s = lib.fl_num_slots(handle)
        verts = np.empty((t, 9), dtype=np.float32)
        normals = np.empty((t, 9), dtype=np.float32)
        uvs = np.empty((t, 6), dtype=np.float32)
        mats = np.empty(t, dtype=np.int32)
        lib.fl_copy_tris(handle, verts.ctypes.data, normals.ctypes.data,
                         uvs.ctypes.data, mats.ctypes.data)
        kind = np.empty(s, dtype=np.int32)
        aabb = np.empty((s, 6), dtype=np.float32)
        skip = np.empty(s, dtype=np.int32)
        tri_index = np.empty(s, dtype=np.int32)
        lib.fl_copy_stream(handle, kind.ctypes.data, aabb.ctypes.data,
                           skip.ctypes.data, tri_index.ctypes.data)
        names = lib.fl_material_names(handle).decode()
        material_names = names.split("\n") if names else []
        return ObjData(verts, normals, uvs, mats, material_names,
                       kind, aabb, skip, tri_index)
    finally:
        lib.fl_release(handle)
