"""Build, load and dispatch the hand-written CUDA kernels.

The kernels under ``csrc/`` are compiled at first use with ``nvcc`` (one
compiler process per source, all started together, then one link) into
one shared library with a plain C interface, keyed on a hash of the
sources and flags, inside the checkout (``build/flexlight_kernels/``, git
ignored), and loaded with ``ctypes``. Each C entry point launches on the
stream it is given and returns ``cudaGetLastError()``.

``--fmad=false`` keeps the compiler from contracting ``a * b + c`` into
one fused multiply-add: every product and sum then rounds exactly as in
the element-wise plain PyTorch versions, so a kernel and its plain twin
agree bit for bit wherever they take the same operations in the same
order. ``--use_fast_math`` stays off for the same reason (``tanhf``,
division, ``floorf``/``fmodf`` must be the IEEE ones).

The same sources also compile for the host with a C++ compiler
(``-DFL_EMULATE``, see ``csrc/common.cuh``): every thread then runs in
turn as a block of one. The CPU tests use that build to check the
kernels' arithmetic against their plain versions without a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "flexlight_kernels"
SOURCES = ("intersect.cu", "disc_filter.cu", "fxaa.cu", "fused.cu", "sparse.cu", "shade.cu",
           "raster.cu")
HEADERS = ("common.cuh", "trace.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas=-v")
HOST_FLAGS = ("-std=c++17", "-O2", "-fPIC", "-ffp-contract=off", "-DFL_EMULATE",
              "-x", "c++")
LIB_NAME = "libflexlight_kernels.so"
LOG_NAME = "build.log"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    # w4, tp, ids, ox, oy, oz, dx, dy, dz, max_len, edge, n, s, u, v, tri, stream
    "fl_closest_hit": [_P, _I, _P] + [_P] * 7 + [_F, _I] + [_P] * 4 + [_P],
    # w4, tp, ox, oy, oz, dx, dy, dz, max_len, n, hit, stream
    "fl_any_hit": [_P, _I] + [_P] * 7 + [_I, _P, _P],
    # id, oid, color, ip, ocolor, h, w, color_out, ip3_out, stream
    "fl_disc_first": [_P] * 5 + [_I, _I, _P, _P, _P],
    # id, oid, color, ip, ocolor, h, w, color_out, ip_out, ocolor_out, stream
    "fl_disc_second": [_P] * 5 + [_I, _I, _P, _P, _P, _P],
    # id, oid, color, ip, ocolor, h, w, hdr, out3, stream
    "fl_disc_final": [_P] * 5 + [_I, _I, _I, _P, _P],
    # img, h, w, out, stream
    "fl_fxaa": [_P, _I, _I, _P, _P],
    # state, dirs, w4, tp, ids, mat, cam, resample, min_importance, n, stream
    "fl_sp_pre": [_P, _P, _P, _I, _P, _P, _P, _I, _F, _I, _P],
    # state, n, list, count, stream
    "fl_sp_live_list": [_P, _I, _P, _P, _P],
    # state, tex, ndc, w4, tp, ids, mat, lights, n_lights, cam, random_seed,
    # cos_sample_n, bounce, do_next, counter, min_importance, n, list, count
    # (fl_sp_live_list's), stream
    "fl_sp_post": [_P, _P, _P, _P, _I, _P, _P, _P, _I, _P, _F, _F, _I, _I, _I, _F, _I,
                   _P, _P, _P],
    # out, dirs, ndc, w4, tp, ids, mat, lights, n_lights, ambient, then per
    # atlas (albedo, pbr, tpo) texels, u8, tile_info, n_slots, meta; cam,
    # seed, cos_samples, spp, inv_spp, bounces, counter, min_importance, n,
    # ray_counter, lane_stats, stream
    "fl_fused_frame": [_P] * 4 + [_I, _P, _P, _P, _I, _P] + [_P, _I, _P, _I, _P] * 3
                      + [_P] * 3 + [_I, _F, _I, _I, _F, _I, _P, _P, _P],
    # amin, amax, wt, ox, oy, oz, dx, dy, dz, max_len, ray_tile, rt, out, stream
    "fl_sparse_flags": [_P, _P, _I] + [_P] * 7 + [_I, _I, _P, _P],
    # bmin, bmax, nb, ox, oy, oz, dx, dy, dz, max_len, n, key, stream
    "fl_sparse_key": [_P, _P, _I] + [_P] * 7 + [_I, _P, _P],
    # rec, tlist, tms, counts, wt, ox, oy, oz, dx, dy, dz, max_len, edge,
    # ray_tile, n, s, u, v, tri, stream
    "fl_sparse_closest": [_P, _P, _P, _P, _I] + [_P] * 7 + [_F, _I, _I] + [_P] * 4 + [_P],
    # rec, tlist, counts, wt, ox, oy, oz, dx, dy, dz, max_len, ray_tile, n, hit, stream
    "fl_sparse_any": [_P, _P, _P, _I] + [_P] * 7 + [_I, _I, _P, _P],
    # state, req, tex, ndc, lights, n_lights, cam, seed, cos_sample_n, bounce,
    # counter, n, list, count (fl_sp_live_list's), stream
    "fl_shade": [_P] * 5 + [_I] + [_P] * 3 + [_I, _I, _I, _P, _P, _P],
    # state, n, list, count, stream
    "fl_alive_list": [_P, _I, _P, _P, _P],
    # state, req, ndc, mat, atlas, lights, n_lights, cam, seed, cos_sample_n,
    # bounce, counter, min_importance, n, list, count (fl_alive_list's), stream
    "fl_interp_shade": [_P] * 6 + [_I] + [_P] * 3 + [_I, _I, _F, _I, _P, _P, _P],
    # geometry, rotations, shifts, hu, hv, slot, n, origin, stream
    "fl_raster_surface": [_P] * 6 + [_I, _P, _P],
    # origin, light, n, rays, stream
    "fl_raster_rays": [_P, _P, _I, _P, _P],
    # geometry, attributes, rotations, then per atlas (albedo, pbr, tpo)
    # texels, u8, tile_info, n_slots, meta; lights, n_lights, ambient, cam,
    # hu, hv, slot, shadowed, hdr, n, rgb, alpha, stream
    "fl_raster_shade": [_P] * 3 + [_P, _I, _P, _I, _P] * 3 + [_P, _I] + [_P] * 6
                       + [_I, _I, _P, _P, _P],
}

_lock = threading.Lock()
_library = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of flexlight_tpu_torch are built "
        "from flexlight_tpu_torch/csrc at first use and need the CUDA "
        "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _source_key(compiler: str, flags) -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join((Path(compiler).name,) + tuple(flags)).encode())
    return h.hexdigest()[:16]


def _open(path: Path):
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def build_library(build_root: Path = BUILD_ROOT, emulate: bool = False):
    """Compile the sources (once per content hash) and load the library.
    The compiler's output (with nvcc, ptxas' registers, shared memory and
    spills of every kernel) is kept beside it, see `build_log`.

    `emulate` builds them for the host with a C++ compiler instead of
    nvcc: a CPU-only library whose entry points take host pointers."""
    if emulate:
        compiler = shutil.which("g++") or shutil.which("c++")
        if compiler is None:
            raise RuntimeError("no host C++ compiler for the emulated build")
        flags = HOST_FLAGS
    else:
        compiler = _nvcc()
        flags = NVCC_FLAGS
    out_dir = Path(build_root) / _source_key(compiler, flags)
    lib_path = out_dir / LIB_NAME
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tag = os.getpid()
        # one compiler per source, all at once; then one link
        objs = [out_dir / f".{Path(src).stem}.{tag}.o" for src in SOURCES]
        cmds = [[compiler, *flags, "-I", str(CSRC), "-c", "-o", str(obj), str(CSRC / src)]
                for src, obj in zip(SOURCES, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for cmd in cmds]
        log = []
        for cmd, proc in zip(cmds, procs):
            out, _ = proc.communicate(timeout=900)
            log.append(f"$ {' '.join(cmd)}\n{out}")
            if proc.returncode != 0:
                raise RuntimeError(f"kernel build failed:\n{log[-1]}")
        tmp = out_dir / f".{LIB_NAME}.{tag}"
        link = [compiler, "-shared", "-o", str(tmp), *(str(o) for o in objs)]
        res = subprocess.run(link, capture_output=True, text=True, timeout=900)
        log.append(f"$ {' '.join(link)}\n{res.stdout}{res.stderr}")
        if res.returncode != 0:
            raise RuntimeError(f"kernel link failed:\n{log[-1]}")
        (out_dir / LOG_NAME).write_text("".join(log))
        for obj in objs:
            obj.unlink()
        os.replace(tmp, lib_path)
    lib = _open(lib_path)
    lib.build_dir = out_dir
    return lib


def build_log(lib) -> str:
    """What the compiler printed when it built `lib`."""
    path = Path(lib.build_dir) / LOG_NAME
    return path.read_text() if path.exists() else ""


def library():
    """The CUDA kernel library, built on first use."""
    global _library
    with _lock:
        if _library is None:
            _library = build_library()
        return _library


def check(status: int, name: str) -> None:
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {status}")


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def require(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    """Raise unless `t` has the dtype, shape, device and contiguity a
    kernel takes."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _first_tensor(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            return a
        if isinstance(a, (tuple, list)):
            t = _first_tensor(a)
            if t is not None:
                return t
    return None


class Kernel:
    """One hand-written kernel behind its plain PyTorch version.

    Called on CPU tensors it runs `plain`; called on any other tensors it
    launches the CUDA kernel or raises (there is no fallback).
    `launches` counts the kernel's launches and nothing else.
    `launch(lib, stream, *args)` checks its arguments, allocates the
    outputs and calls the C entry point; `run` launches and counts, for a
    wrapper that launches another kernel before its own."""

    def __init__(self, name: str, plain, launch):
        self.name = name
        self.plain = plain
        self.launch = launch
        self.launches = 0

    def __call__(self, *args, **kwargs):
        t = _first_tensor(args)
        if t is None:
            raise TypeError(f"{self.name}: no tensor argument")
        if t.device.type == "cpu":
            return self.plain(*args, **kwargs)
        lib = library()
        if t.device.type != "cuda":
            raise ValueError(f"{self.name}: tensors on {t.device} are neither "
                             "CPU nor CUDA tensors")
        return self.run(lib, torch.cuda.current_stream(t.device).cuda_stream, *args, **kwargs)

    def run(self, lib, stream, *args, **kwargs):
        out = self.launch(lib, stream, *args, **kwargs)
        self.launches += 1
        return out

    def __repr__(self) -> str:
        return f"Kernel({self.name!r}, launches={self.launches})"
