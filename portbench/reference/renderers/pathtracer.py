"""The path tracer's delivered frame, worked out again in plain PyTorch:
the reference of a configuration whose `reference` is "pathtracer".

`Reference` flattens the scene the configuration's scene file built from
the frozen copy, and renders the frames a delivered frame depends on:
with temporal averaging over T samples, frame j's display is the post
chain over the MRT passes of frames j-T+1 .. j, each from its pose, the
scene put in the state of that frame, and with the noise phase j % T.
Every pass runs the plain versions of the kernels (`PLAIN`); the post
chain (`postprocess`) is a copy of models/pathtracer.py's, with FXAA or
no anti-aliasing.

`precision="bfloat16"` is the control: the same frames with every float
input of the frame (scene buffers, atlases, camera) and every MRT channel
rounded to bfloat16, the step below the float32 the configuration states.
`counting()` records the live rays and hits of every cast, which the
roofline metrics read.
"""

from __future__ import annotations

import contextlib
from functools import partial
from types import SimpleNamespace

import numpy as np
import torch

from portbench.reference.frozen.config import Config
from portbench.reference.frozen.ops import fused as fused_ops
from portbench.reference.frozen.ops import intersect_kernel as ik
from portbench.reference.frozen.ops import intersect_sparse_kernel as isk
from portbench.reference.frozen.ops.buffers import AtlasTable, build_scene_buffers
from portbench.reference.frozen.ops.pathtrace import render_mrt
from portbench.reference.frozen.post import filter_kernel as fk
from portbench.reference.frozen.post.common import quantize_rgba8, split_hdr
from portbench.reference.frozen.post.fxaa import fxaa
from portbench.reference.frozen.post.temporal import (TemporalState, push_frame,
                                                      temporal_average)
from portbench.reference.frozen.scene import transform

SPARSE_MIN_TRIS = 4096      # models/pathtracer.py: "auto" takes sparse from here

PLAIN = SimpleNamespace(
    closest_hit=ik.closest_hit_plain, any_hit=ik.any_hit_plain,
    first_blur=fk.first_blur, second_blur=fk.second_blur, final_blur=fk.final_blur,
    fxaa=fxaa, sp_pre=fused_ops.sp_pre_plain, sp_post=fused_ops.sp_post_plain,
    sparse_flags=isk.sparse_flags, sparse_key=isk.sparse_key,
    sparse_closest=isk.sparse_closest, sparse_any=isk.sparse_any,
    fused_frame=fused_ops.fused_frame_plain)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32) if t.is_floating_point() else t


class Reference:
    """The frames of a configuration's scene on `device`: `engine` is the
    frozen copy's engine the scene file built, `at(frame)` puts its scene
    in the state of frame number `frame` (None: a static scene), after
    the camera has been set to that frame's pose."""

    def __init__(self, cfg: dict, engine, at, device):
        self.at = at
        self.camera = engine.camera
        self.config = Config(**cfg["config"])
        q = self.config.render_quality
        self.width = max(int(cfg["width"] * q), 1)
        self.height = max(int(cfg["height"] * q), 1)
        self.buffers = build_scene_buffers(engine.scene, torch.device(device))
        self.scheme = cfg["scheme"]
        if self.scheme == "auto":
            if self.buffers.id_buffer.shape[0] >= SPARSE_MIN_TRIS:
                self.scheme = "sparse"
            elif fused_ops.fused_split_eligible(self.buffers):
                self.scheme = "fused_split"
            else:
                self.scheme = "kernel"
        if self.config.antialiasing not in ("fxaa", None):
            raise ValueError(f"the path tracer's reference has no {self.config.antialiasing!r}")

    def frames_of(self, frame: int) -> list[int]:
        """The frame numbers whose MRT passes a delivered frame averages."""
        t = self.config.temporal_samples if self.config.temporal else 1
        return list(range(max(frame - t + 1, 0), frame + 1))

    def shape(self) -> dict:
        b = self.buffers
        return {"pixels": self.width * self.height, "triangles": int(b.id_buffer.shape[0]),
                "lights": int(b.lights.shape[0]),
                "texture_bytes": sum(tab.texels.numel() * tab.texels.element_size()
                                     for tab in (b.albedo_tab, b.pbr_tab, b.tpo_tab))}

    def _at(self, pose, frame: int, precision: str):
        """(buffers, camera position, view matrix) of frame `frame` at `pose`."""
        cam = self.camera
        cam.x, cam.y, cam.z, cam.fx, cam.fy = pose
        if self.at is not None:
            self.at(frame)
        rot, shift = transform.global_registry().build_arrays()
        dev = self.buffers.geometry.device
        buffers = self.buffers._replace(rotations=torch.as_tensor(rot, device=dev),
                                        shifts=torch.as_tensor(shift, device=dev))
        position, view = cam.position, cam.view_matrix(self.width, self.height)
        if precision == "bfloat16":
            fields = {}
            for name, value in buffers._asdict().items():
                fields[name] = (AtlasTable(*(_bf16(t) for t in value))
                                if isinstance(value, AtlasTable) else _bf16(value))
            buffers = buffers._replace(**fields)
            position = _bf16(torch.as_tensor(position)).numpy()
            view = _bf16(torch.as_tensor(view)).numpy()
        return buffers, position, view

    def mrt(self, pose, frame: int, precision: str = "float32"):
        buffers, position, view = self._at(pose, frame, precision)
        seed = float(frame % self.config.temporal_samples) if self.config.temporal else 0.0
        mrt = render_mrt(buffers, self.width, self.height, position, view, self.config, seed,
                         scheme=self.scheme, kernels=PLAIN)
        if precision == "bfloat16":
            mrt = mrt._replace(**{k: _bf16(v) for k, v in mrt._asdict().items()})
        return mrt

    def display_u8(self, poses, frames, precision: str = "float32") -> np.ndarray:
        """The [H, W, 3] uint8 frame the program delivers for the last of
        `frames` (frames_of its frame number, with their `poses`)."""
        h, w = self.height, self.width
        state = TemporalState.create(self.config.temporal_samples, h, w,
                                     self.buffers.geometry.device)
        display = None
        for i, (pose, frame) in enumerate(zip(poses, frames)):
            mrt = self.mrt(pose, frame, precision)
            if i + 1 < len(frames):
                _, _, color_q, ip_q, id_q, oid_q, _ = _quantized_mrt(mrt, h, w)
                state = push_frame(state, color_q, ip_q, id_q, oid_q)
            else:
                display = postprocess(mrt, state, w, h, self.config)
            del mrt
        return torch.round(torch.clamp(display, 0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy()

    @staticmethod
    def counting():
        return counting()


@contextlib.contextmanager
def counting():
    """Record every cast of the frames rendered inside: yields a dict of
    lists, per cast, of live rays (max_len > 0) and, for closest hits, of
    the live rays that hit."""
    counts = {"closest_live": [], "closest_hits": [], "any_live": []}

    def closest(fn, *a):
        out = fn(*a)
        live = a[6] > 0 if fn is isk.sparse_closest else a[4] > 0
        counts["closest_live"].append(int(live.sum()))
        counts["closest_hits"].append(int((live & (out[3] >= 0)).sum()))
        return out

    def any_(fn, *a):
        live = a[5] > 0 if fn is isk.sparse_any else a[3] > 0
        counts["any_live"].append(int(live.sum()))
        return fn(*a)

    saved = (PLAIN.closest_hit, PLAIN.any_hit, PLAIN.sparse_closest, PLAIN.sparse_any,
             fused_ops.closest_hit_plain, fused_ops.any_hit_plain)
    PLAIN.closest_hit = fused_ops.closest_hit_plain = partial(closest, ik.closest_hit_plain)
    PLAIN.any_hit = fused_ops.any_hit_plain = partial(any_, ik.any_hit_plain)
    PLAIN.sparse_closest = partial(closest, isk.sparse_closest)
    PLAIN.sparse_any = partial(any_, isk.sparse_any)
    try:
        yield counts
    finally:
        (PLAIN.closest_hit, PLAIN.any_hit, PLAIN.sparse_closest, PLAIN.sparse_any,
         fused_ops.closest_hit_plain, fused_ops.any_hit_plain) = saved


# ---------------------------------------------------------------------------
# the post chain: a copy of flexlight_tpu_torch/models/pathtracer.py's
# _quantized_mrt, _filter_chain_packed and postprocess_mrt (FXAA or none)
# ---------------------------------------------------------------------------

def _quantized_mrt(mrt, height: int, width: int):
    def img(x, c=None):
        return x.reshape(height, width) if c is None else x.reshape(height, width, c)

    color = img(mrt.color, 3)
    alpha = img(mrt.alpha)
    frac_q, high_q = split_hdr(color)
    color_q = torch.cat([frac_q, alpha[..., None]], dim=-1)
    ip_q = torch.cat([high_q, quantize_rgba8(img(mrt.glass))[..., None]], dim=-1)
    id_q = quantize_rgba8(img(mrt.render_id, 4))
    oid_q = torch.cat([torch.zeros_like(color),
                       quantize_rgba8(img(mrt.original_id_w))[..., None]], dim=-1)
    ocolor_q = quantize_rgba8(torch.cat(
        [img(mrt.original_color, 3), img(mrt.original_w)[..., None]], dim=-1))
    return color, alpha, color_q, ip_q, id_q, oid_q, ocolor_q


def _filter_chain_packed(config: Config, r0, ip0, oc0, id0, oid):
    key_fn = fk.tileize_blur_key_packed if config.filter_mode == "fast" else (lambda x: x)
    first_fn = partial(fk.first_filter_packed, blur=PLAIN.first_blur)
    second_fn = partial(fk.second_filter_packed, blur=PLAIN.second_blur)
    final_fn = partial(fk.final_filter_packed, hdr=config.hdr, blur=PLAIN.final_blur)
    r0p, ip0p, oc0p, id0p, oidp = (fk.pack_rgba8(x) for x in (r0, ip0, oc0, id0, oid))
    zeros = torch.zeros_like(r0p)
    render = {0: r0p, 1: zeros, 2: zeros, 3: zeros}
    ip = {0: ip0p, 1: zeros, 2: zeros, 3: zeros}
    ids = {0: id0p, 1: zeros}
    ocolor = {0: key_fn(oc0p), 1: zeros}
    n = n_id = n_original = 0
    first, second = config.first_passes, config.second_passes
    for i in range(first + second):
        np_ = (i % 2) ^ 1
        npo = ((i - first) % 2) ^ 1
        if i >= first:
            np_ += 2
        inputs = (render[n], ip[n], ocolor[n_original], ids[n_id], oidp)
        if i < first:
            c, p, idout = first_fn(*inputs)
            render[np_], ip[np_] = c, p
            ids[np_] = idout
        else:
            c, p, oc = second_fn(*inputs)
            render[np_], ip[np_] = c, p
            if i - 2 >= first:
                ocolor[npo] = key_fn(oc)  # earlier second passes: dropped
        n = np_
        if i >= first:
            n_original = npo
        else:
            n_id = np_
    index = 2 + (first + second) % 2
    return final_fn(render[index], ip[index], ocolor[second % 2], ids[first % 2], oidp)


def postprocess(mrt, temporal_state: TemporalState, width: int, height: int,
                config: Config) -> torch.Tensor:
    """temporal -> denoise -> FXAA: the display [H, W, 3] in [0, 1]."""
    color, alpha, color_q, ip_q, id_q, oid_q, ocolor_q = _quantized_mrt(mrt, height, width)
    use_aa = config.antialiasing == "fxaa"
    if config.temporal:
        temporal_state = push_frame(temporal_state, color_q, ip_q, id_q, oid_q)
        t_color, t_glass, center_w = temporal_average(temporal_state)
        if config.filter:
            frac_q, high_q = split_hdr(t_color)
            r0 = torch.cat([frac_q, center_w[..., None]], dim=-1)
            ip0 = torch.cat([high_q, quantize_rgba8(t_glass)[..., None]], dim=-1)
            display = _filter_chain_packed(config, r0, ip0, ocolor_q, id_q, oid_q)
        else:
            display = torch.clamp(t_color, 0.0, 1.0)
            if use_aa:
                display = quantize_rgba8(display)
    elif config.filter:
        display = _filter_chain_packed(config, color_q, ip_q, ocolor_q, id_q, oid_q)
    else:
        display = torch.clamp(color * mrt.original_color.reshape(height, width, 3), 0.0, 1.0)
    if use_aa:
        aa_in = torch.cat([quantize_rgba8(display),
                           (alpha > 0).to(torch.float32)[..., None]], dim=-1)
        display = PLAIN.fxaa(aa_in)[..., 0:3]
    return torch.clamp(display, 0.0, 1.0)
