"""Checkpoint / resume (flexlight_tpu/utils/checkpoint.py on torch).

The reference's closest mechanisms are localStorage config persistence and
static-baked scene buffers (SURVEY §5). Here both become real artifacts,
in flexlight_tpu's npz layout (keys `meta`, `temporal_{color,ip,ids,oid}`,
`taa_history`; `geometry`, `attributes`, `id_buffer`, `min_max`, `lights`,
`ambient`), so a file written by either package loads in the other:

- save/load of the renderer's accumulated history state (temporal ring,
  TAA history, frame counter) so a long accumulation can resume;
- save/load of flattened scene arrays so dragon-scale scenes skip the
  host-side BVH/flatten cost on reload (the staticPermanent analogue).

The port keeps a TAA history only under antialiasing="taa"
(post.taa.taa_history), so it writes `taa_history` only when it holds one
and loads it only under TAA; flexlight_tpu always writes one and loads a
file without it.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch


def snapshot_render_state(renderer) -> dict:
    """Host-side (numpy) copy of the renderer's resumable state.

    This is the only step that reads the device; utils.failover keeps the
    latest snapshot so a checkpoint can still be written after the device
    fails (a failed CUDA context cannot be read, see failover)."""
    state = {
        "frame_count": renderer._frame_count,
        "config": dataclasses.asdict(renderer.config),
        "width": renderer.width,
        "height": renderer.height,
    }
    arrays = {}
    if renderer._temporal_state is not None:
        for name, arr in renderer._temporal_state._asdict().items():
            arrays[f"temporal_{name}"] = _host(arr)
    if renderer._taa_state is not None:
        arrays["taa_history"] = _host(renderer._taa_state.history)
    return {"meta": state, "arrays": arrays}


def _host(x) -> np.ndarray:
    """A host copy of `x` (also of a CPU tensor: the snapshot must not
    change with the renderer)."""
    return x.detach().to("cpu", copy=True).numpy()


def write_render_state(path: str, snapshot: dict) -> None:
    """Persist a snapshot_render_state() dict. Pure host IO."""
    np.savez_compressed(path, meta=json.dumps(snapshot["meta"]),
                        **snapshot["arrays"])


def save_render_state(path: str, renderer) -> None:
    write_render_state(path, snapshot_render_state(renderer))


def load_render_state(path: str, renderer) -> None:
    """Restore a checkpoint into `renderer` (prepared first), its tensors
    on `renderer.device`: the frame counter, the temporal ring (four
    tensors of their own) and, under antialiasing="taa", the TAA history
    when the file has one."""
    from ..post.taa import TAAState
    from ..post.temporal import TemporalState

    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["meta"]))
    if (meta["width"], meta["height"]) != (renderer.width, renderer.height):
        raise ValueError("checkpoint resolution mismatch")
    renderer._prepare()
    renderer._frame_count = int(meta["frame_count"])

    def dev(key):
        return torch.as_tensor(np.array(data[key], dtype=np.float32), device=renderer.device)

    if "temporal_color" in data:
        renderer._temporal_state = TemporalState(
            color=dev("temporal_color"), ip=dev("temporal_ip"),
            ids=dev("temporal_ids"), oid=dev("temporal_oid"))
    if "taa_history" in data and renderer._taa_state is not None:
        renderer._taa_state = TAAState(history=dev("taa_history"))


def save_scene_cache(path: str, scene) -> None:
    """Persist the flattened scene arrays (staticPermanent analogue,
    scene.js:870-882)."""
    built = scene.generate_arrays()
    np.savez_compressed(
        path,
        geometry=built.geometry,
        attributes=built.attributes,
        id_buffer=built.id_buffer,
        min_max=built.min_max,
        lights=scene.build_light_array(),
        ambient=np.asarray(scene.ambient_light, dtype=np.float32),
    )


def load_scene_cache(path: str, device):
    """SceneBuffers on `device` built from a cache file (no host scene
    walk). As in flexlight_tpu, textures are not cached: the three atlases
    are 1x1 zeros, with the atlas tables build_atlas_table makes for no
    texture; the transforms come from the current global registry."""
    from ..ops.buffers import SceneBuffers, build_atlas_table
    from ..scene.transform import global_registry

    data = np.load(path)
    rotations, shifts = global_registry().build_arrays()

    def t(a, dtype=None):
        return torch.as_tensor(np.asarray(a, dtype=dtype), device=device)

    zero_atlas = np.zeros((1, 1, 3), dtype=np.float32)
    return SceneBuffers(
        geometry=t(data["geometry"]),
        attributes=t(data["attributes"]),
        id_buffer=t(data["id_buffer"], np.int32),
        rotations=t(rotations),
        shifts=t(shifts),
        lights=t(data["lights"]),
        ambient=t(data["ambient"]),
        albedo_atlas=t(zero_atlas),
        pbr_atlas=t(zero_atlas),
        tpo_atlas=t(zero_atlas),
        texture_width=t(1.0, np.float32),
        albedo_tab=build_atlas_table([], (1, 1), device),
        pbr_tab=build_atlas_table([], (1, 1), device),
        tpo_tab=build_atlas_table([], (1, 1), device),
    )
