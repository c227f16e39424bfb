"""Bounded-halo exchange for sharded post-processing
(flexlight_tpu/parallel/halo.py on torch.distributed).

The denoise stencils (37-tap discs with a per-pixel radius,
pathtracer_first_filter.glsl:96-117) and FXAA read neighbourhoods across
the borders of the image strips. Instead of gathering whole frames, each
rank swaps `halo` border rows with its neighbours on the mesh's "tile"
axis by point-to-point send / receive (flexlight_tpu's `ppermute`); a rank
at the image border gets zero rows there, texelFetch's result outside
the image, so a lifted pass matches the one-process pass wherever its
reach fits the halo.

The collectives run on the mesh's process groups. The mesh's device type
chooses the transport: a "cpu" mesh (gloo) carries host copies of the
tensors, a "cuda" mesh (NCCL) the device tensors themselves; results come
back on the device the caller's tensors are on. Nothing here catches a
failed collective."""

from __future__ import annotations

import torch
import torch.distributed as dist


def mesh_axis(mesh, name: str):
    """(process group, this rank's coordinate, size) of a mesh axis."""
    return (mesh.get_group(name), mesh.get_local_rank(name),
            mesh.size(mesh.mesh_dim_names.index(name)))


def wire(x: torch.Tensor, mesh) -> torch.Tensor:
    """x as the mesh's transport carries it: a contiguous host copy on a
    "cpu" mesh, the tensor itself (contiguous) on a "cuda" one."""
    dev = "cpu" if mesh.device_type == "cpu" else x.device
    return x.detach().to(dev).contiguous()


def all_reduce(x: torch.Tensor, op, mesh, name: str) -> torch.Tensor:
    """x reduced over the axis (flexlight_tpu's psum / pmin)."""
    group, _, size = mesh_axis(mesh, name)
    if size == 1:
        return x
    t = wire(x, mesh).clone()
    dist.all_reduce(t, op=op, group=group)
    return t.to(x.device)


def all_gather(x: torch.Tensor, mesh, name: str, dim: int = 0) -> torch.Tensor:
    """The axis' tensors concatenated along `dim` in coordinate order
    (flexlight_tpu's all_gather(tiled=True))."""
    group, _, size = mesh_axis(mesh, name)
    if size == 1:
        return x
    t = wire(x, mesh)
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


def broadcast(x: torch.Tensor, src: int, mesh, name: str) -> torch.Tensor:
    """The tensor of the rank at coordinate `src` of the axis, on every
    rank of it."""
    group, _, size = mesh_axis(mesh, name)
    if size == 1:
        return x
    t = wire(x, mesh).clone()
    dist.broadcast(t, src=dist.get_global_rank(group, src), group=group)
    return t.to(x.device)


def exchange_halo(x: torch.Tensor, halo: int, mesh, axis_name: str = "tile") -> torch.Tensor:
    """x: this rank's strip [rows, ...] -> [rows + 2 * halo, ...]: the last
    `halo` rows of the strip above on top, the first `halo` rows of the
    strip below at the bottom, zero rows where there is no neighbour."""
    group, idx, size = mesh_axis(mesh, axis_name)
    t = wire(x, mesh)
    above = torch.zeros_like(t[:halo])
    below = torch.zeros_like(t[:halo])
    ops = []
    if idx > 0:
        peer = dist.get_global_rank(group, idx - 1)
        ops += [dist.P2POp(dist.isend, t[:halo].contiguous(), peer, group),
                dist.P2POp(dist.irecv, above, peer, group)]
    if idx < size - 1:
        peer = dist.get_global_rank(group, idx + 1)
        ops += [dist.P2POp(dist.isend, t[t.shape[0] - halo:].contiguous(), peer, group),
                dist.P2POp(dist.irecv, below, peer, group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return torch.cat([above, t, below]).to(x.device)


def with_halo(fn, halo: int, mesh, axis_name: str = "tile"):
    """Lift an image-local op (strips [rows, W, ...] -> a tensor or a tuple
    of them) to sharded strips: exchange halos on every input, apply, crop
    the halo rows off every output."""

    def crop(y):
        return y[halo:y.shape[0] - halo]

    def wrapped(*strips):
        out = fn(*(exchange_halo(x, halo, mesh, axis_name) for x in strips))
        return tuple(crop(y) for y in out) if isinstance(out, (tuple, list)) else crop(out)

    return wrapped
