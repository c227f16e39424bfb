"""Multi-process runtime glue: start-up and the scene broadcast
(flexlight_tpu/parallel/multihost.py on torch.distributed).

Scene flattening is host-side Python (OBJ import, BVH build, atlas
packing), so only rank 0's buffers count: every rank flattens the same
scene (the broadcast needs matching shapes) and then takes rank 0's
tensors, one broadcast each, so the device buffers are bit-identical on
every rank even if a host's libm or BVH tie-breaks ever differ.

A single process (tests, the one-card runs) needs none of it:
`initialize()` without arguments is a no-op and `broadcast_scene` returns
the local buffers."""

from __future__ import annotations

import torch
import torch.distributed as dist


def world_backend() -> str:
    """The world's backends: gloo for CPU tensors, and NCCL for CUDA
    tensors where torch has both. A collective takes the backend of its
    tensors' device, so the mesh's device type alone chooses the
    transport (parallel.halo.wire); NCCL sets up its communicators only
    at the first collective on CUDA tensors, so a world whose ranks share
    one card runs on a "cpu" mesh."""
    if torch.cuda.is_available() and dist.is_nccl_available():
        return "cpu:gloo,cuda:nccl"
    return "gloo"


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Join the process group: `coordinator_address` is "host:port" (TCP)
    or an init_method URL (tcp://..., file://...), with this process's
    rank `process_id` among `num_processes`, on `world_backend()`. No-op
    when unconfigured."""
    if num_processes is None and coordinator_address is None:
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("initialize needs coordinator_address, num_processes and process_id")
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(world_backend(), init_method=url, world_size=num_processes,
                            rank=process_id)


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def is_leader() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def broadcast_scene(buffers):
    """Rank 0's SceneBuffers on every rank, tensor by tensor (the nested
    atlas tables too), as host copies over gloo whatever the mesh's
    transport: the scene goes once, at set-up, and ranks that share a
    card can take it too. A non-leader may pass zero-filled buffers of
    the same shapes. One process: `buffers` unchanged."""
    if not _distributed():
        return buffers

    def bcast(x):
        if isinstance(x, tuple):
            return type(x)(*(bcast(y) for y in x))
        t = x.detach().cpu().contiguous().clone()
        dist.broadcast(t, src=0)
        return t.to(x.device)

    return bcast(buffers)


def build_and_broadcast(scene, device):
    """Flatten the scene graph onto `device` and take the leader's buffers."""
    from ..ops.buffers import build_scene_buffers

    return broadcast_scene(build_scene_buffers(scene, device))

