"""Device scene buffers.

The flattened scene as tensors on one device: the input contract between
the host scene layer (flexlight_tpu_torch.scene) and every
kernel. Field for field the same as flexlight_tpu/ops/buffers.py:

- geometry [S, 12], attributes [S, 28] (scene.js:294-298, 636-641)
- rotations [M, 2, 3, 3] / shifts [M, 2, 3] (scene.js:500-521)
- lights [L, 2, 3] (pathtracerWGL2.js:154-165)
- 3 texture atlases, 2048 px-wide tile rows (pathtracerWGL2.js:85-104),
  and their compact texel tables (AtlasTable), which the hot path reads.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

ATLAS_WIDTH_PX = 2048  # pathtracerWGL2.js:93
INV_255_F32 = np.float32(1.0 / 255.0)


class AtlasTable(NamedTuple):
    """Compact texel table: each tile at min(native, standard) resolution
    in one flat texel list plus a per-slot (offset, stored_w, stored_h)
    directory. Reads the same values as the padded atlas (see
    flexlight_tpu.ops.buffers.AtlasTable).

    texels: [K, 3] float32, or uint8 where u8 * f32(1/255) reproduces the
        float data bit-exactly; tile_info: [S, 3] int32;
    meta: [5] int32 (std_w, std_h, tiles_per_row, virt_h, virt_w)."""
    texels: torch.Tensor
    tile_info: torch.Tensor
    meta: torch.Tensor


class SceneBuffers(NamedTuple):
    geometry: torch.Tensor       # [S, 12] f32
    attributes: torch.Tensor     # [S, 28] f32
    id_buffer: torch.Tensor      # [T] int32: triangle slot per drawable
    rotations: torch.Tensor      # [M, 2, 3, 3] f32
    shifts: torch.Tensor         # [M, 2, 3] f32
    lights: torch.Tensor         # [L, 2, 3] f32
    ambient: torch.Tensor        # [3] f32
    albedo_atlas: torch.Tensor   # [Ha, Wa, 3] f32
    pbr_atlas: torch.Tensor      # [Hp, Wp, 3] f32
    tpo_atlas: torch.Tensor      # [Ht, Wt, 3] f32
    texture_width: torch.Tensor  # [] f32: tiles per atlas row
    albedo_tab: AtlasTable
    pbr_tab: AtlasTable
    tpo_tab: AtlasTable


def build_atlas(textures, standard_size) -> np.ndarray:
    """Pack textures into 2048 px-wide rows of standard-size tiles
    (pathtracerWGL2.js:85-104). Returns [H, W, 3] float32."""
    if not textures:
        return np.zeros((1, 1, 3), dtype=np.float32)
    width, height = int(standard_size[0]), int(standard_size[1])
    tiles_per_row = max(ATLAS_WIDTH_PX // width, 1)
    n = len(textures)
    atlas = np.zeros((height * n, width * tiles_per_row, 3), dtype=np.float32)
    for i, tex in enumerate(textures):
        row, col = i // tiles_per_row, i % tiles_per_row
        data = tex.data
        if data.shape[0] != height or data.shape[1] != width:
            ys = (np.arange(height) * data.shape[0] // height).clip(0, data.shape[0] - 1)
            xs = (np.arange(width) * data.shape[1] // width).clip(0, data.shape[1] - 1)
            data = data[ys][:, xs]
        atlas[row * height:(row + 1) * height, col * width:(col + 1) * width] = data
    return atlas


def build_atlas_table_np(textures, standard_size):
    """Host arrays (texels, tile_info, meta) of the compact table."""
    std_w, std_h = int(standard_size[0]), int(standard_size[1])
    tpr = max(ATLAS_WIDTH_PX // std_w, 1)
    if not textures:
        # the 1x1 zero placeholder atlas: any non-miss fetch reads 0
        return (np.zeros((1, 3), dtype=np.float32),
                np.asarray([[0, 1, 1]], dtype=np.int32),
                np.asarray([1, 1, 1, 1, 1], dtype=np.int32))
    n = len(textures)
    rows, texel_rows, off = [], [], 0
    for tex in textures:
        d = np.asarray(tex.data, dtype=np.float32)
        if d.shape[0] * d.shape[1] > std_h * std_w:
            ys = (np.arange(std_h) * d.shape[0] // std_h).clip(0, d.shape[0] - 1)
            xs = (np.arange(std_w) * d.shape[1] // std_w).clip(0, d.shape[1] - 1)
            d = d[ys][:, xs]
        rows.append((off, d.shape[1], d.shape[0]))
        texel_rows.append(d.reshape(-1, 3))
        off += d.shape[0] * d.shape[1]
    zero_off = off  # one zero texel backs every padding slot
    texel_rows.append(np.zeros((1, 3), dtype=np.float32))
    for _ in range(n, n * tpr):
        rows.append((zero_off, 1, 1))
    texels = np.concatenate(texel_rows, axis=0)
    q = np.round(texels * 255.0)
    if (texels >= 0).all() and (texels <= 1).all() and np.array_equal(
            q.astype(np.float32) * INV_255_F32, texels):
        texels = q.astype(np.uint8)
    return (texels, np.asarray(rows, dtype=np.int32),
            np.asarray([std_w, std_h, tpr, std_h * n, std_w * tpr], dtype=np.int32))


def build_atlas_table(textures, standard_size, device) -> AtlasTable:
    return AtlasTable(*(torch.as_tensor(a, device=device)
                        for a in build_atlas_table_np(textures, standard_size)))


def fetch_tex_val_table(table: AtlasTable, u, v, tex_num, default3):
    """Atlas lookup (pathtracer_fragment.glsl:108-117) through the compact
    table: NEAREST sampling with REPEAT wrap; `default3` where tex_num is
    -1. A plain index gather (flexlight_tpu's one-hot MXU forms give the
    same values)."""
    texels, tile_info, meta = table
    n_slots = tile_info.shape[0]
    miss = tex_num == -1.0
    std_w, std_h, tpr = meta[0], meta[1], meta[2]
    hf = meta[3].to(torch.float32)
    wf = meta[4].to(torch.float32)
    tw = tpr.to(torch.float32)
    height_factor = wf / hf
    cx = (u + torch.remainder(tex_num, tw)) / tw
    cy = (v + torch.floor(tex_num / tw)) * height_factor / tw
    px = torch.floor(torch.remainder(cx, 1.0) * wf).to(torch.int32)
    px = torch.minimum(torch.clamp_min(px, 0), meta[4] - 1)
    py = torch.floor(torch.remainder(cy, 1.0) * hf).to(torch.int32)
    py = torch.minimum(torch.clamp_min(py, 0), meta[3] - 1)
    col = torch.div(px, std_w, rounding_mode="floor")
    row = torch.div(py, std_h, rounding_mode="floor")
    slot = torch.clamp(row * tpr + col, 0, n_slots - 1).long()
    info = tile_info[slot]
    off, sw, sh = info[:, 0], info[:, 1], info[:, 2]
    # standard-tile pixel -> stored-tile pixel (build_atlas's resample)
    sx = torch.div((px - col * std_w) * sw, std_w, rounding_mode="floor")
    sy = torch.div((py - row * std_h) * sh, std_h, rounding_mode="floor")
    idx = (off + sy * sw + sx).long()
    out = []
    for c, d in enumerate(default3):
        ch = texels[:, c][idx].to(torch.float32)
        if texels.dtype == torch.uint8:
            ch = ch * float(INV_255_F32)
        out.append(torch.where(miss, d, ch))
    return tuple(out)


def build_scene_buffers(scene, device, registry=None) -> SceneBuffers:
    """Flatten a host Scene into tensors on `device` (the updateScene
    equivalent, pathtracerWGL2.js:167-189)."""
    from ..scene.transform import global_registry

    built = scene.generate_arrays()
    registry = registry or global_registry()
    rotations, shifts = registry.build_arrays()
    lights = scene.build_light_array()
    size = scene.standard_texture_sizes
    tiles_per_row = max(ATLAS_WIDTH_PX // int(size[0]), 1)

    def t(a, dtype=None):
        return torch.as_tensor(np.asarray(a, dtype=dtype), device=device)

    return SceneBuffers(
        geometry=t(built.geometry),
        attributes=t(built.attributes),
        id_buffer=t(built.id_buffer, np.int32),
        rotations=t(rotations),
        shifts=t(shifts),
        lights=t(lights),
        ambient=t(scene.ambient_light, np.float32),
        albedo_atlas=t(build_atlas(scene.textures, size)),
        pbr_atlas=t(build_atlas(scene.pbr_textures, size)),
        tpo_atlas=t(build_atlas(scene.translucency_textures, size)),
        texture_width=t(tiles_per_row, np.float32),
        albedo_tab=build_atlas_table(scene.textures, size, device),
        pbr_tab=build_atlas_table(scene.pbr_textures, size, device),
        tpo_tab=build_atlas_table(scene.translucency_textures, size, device),
    )


def buffers_from_numpy(arrays, device) -> SceneBuffers:
    """SceneBuffers from another implementation's buffers as numpy arrays
    (e.g. flexlight_tpu's SceneBuffers mapped through np.asarray): the
    same scene data carried across, so both render from identical inputs.
    `arrays` is a NamedTuple or mapping with this class's field names."""
    get = arrays._asdict() if hasattr(arrays, "_asdict") else dict(arrays)

    def t(a):
        return torch.as_tensor(np.array(a), device=device)

    fields = {}
    for name in SceneBuffers._fields:
        val = get[name]
        if name.endswith("_tab"):
            tab = val._asdict() if hasattr(val, "_asdict") else dict(val)
            fields[name] = AtlasTable(**{k: t(tab[k]) for k in AtlasTable._fields})
        else:
            fields[name] = t(val)
    return SceneBuffers(**fields)


def taa_state_from_numpy(state, device):
    """post.taa.TAAState from another implementation's TAA state with its
    `history` as a numpy array (e.g. flexlight_tpu's mapped through
    np.asarray), so that both go on from the same history."""
    from ..post.taa import TAAState

    return TAAState(history=torch.as_tensor(np.array(state.history, dtype=np.float32),
                                            device=device))
