"""Temporal accumulation (flexlight_tpu/post/temporal.py): average up to
`temporal_samples` history frames, gated per pixel on exact equality of
the quantized id channel, and a glass counter gated on the originalId
channel (the generated shader, pathtracerWGL2.js:571-662)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class TemporalState(NamedTuple):
    """History ring, newest frame at index 0. All RGBA8-quantized."""
    color: torch.Tensor   # [T, H, W, 4]  fract color + alpha
    ip: torch.Tensor      # [T, H, W, 4]  floor/256 color + glassFilter
    ids: torch.Tensor     # [T, H, W, 4]
    oid: torch.Tensor     # [T, H, W, 4]

    @staticmethod
    def create(temporal_samples: int, height: int, width: int, device) -> "TemporalState":
        z = torch.zeros((temporal_samples, height, width, 4), dtype=torch.float32,
                        device=device)
        return TemporalState(color=z, ip=z, ids=z, oid=z)


def push_frame(state: TemporalState, color_q, ip_q, id_q, oid_q) -> TemporalState:
    """Rotate the ring: new frame in, oldest out (pathtracerWGL2.js:391-394)."""
    def rot(ring, new):
        return torch.cat([new[None], ring[:-1]], dim=0)

    return TemporalState(color=rot(state.color, color_q), ip=rot(state.ip, ip_q),
                         ids=rot(state.ids, id_q), oid=rot(state.oid, oid_q))


def temporal_average(state: TemporalState):
    """The generated temporal kernel (pathtracerWGL2.js:595-639).
    Returns (color [H,W,3] fp32 HDR, glass [H,W], center_w [H,W])."""
    cur_id = state.ids[0]
    cur_oid = state.oid[0]
    center_w = state.color[0, :, :, 3]
    color = state.color[0, :, :, 0:3] + state.ip[0, :, :, 0:3] * 256.0
    counter = torch.ones_like(center_w)
    glass = state.ip[0, :, :, 3]
    glass_counter = torch.ones_like(center_w)
    for j in range(1, state.color.shape[0]):
        id_match = (state.ids[j] == cur_id).all(dim=-1)
        c_j = state.color[j, :, :, 0:3] + state.ip[j, :, :, 0:3] * 256.0
        color = torch.where(id_match[..., None], color + c_j, color)
        counter = counter + id_match.to(torch.float32)
        oid_match = (state.oid[j] == cur_oid).all(dim=-1)
        glass = torch.where(oid_match, glass + state.ip[j, :, :, 3], glass)
        glass_counter = glass_counter + oid_match.to(torch.float32)
    return color / counter[..., None], glass / glass_counter, center_w
