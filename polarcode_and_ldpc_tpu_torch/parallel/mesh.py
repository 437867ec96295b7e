"""Device meshes, frame sharding and the collectives the sharded paths use.

Monte-Carlo FEC simulation is embarrassingly parallel over frames: the only
communication is the error-count reduction.  PyTorch has no single-process
mesh over several devices; its idiom is one process per device in a
``torch.distributed`` group.  A mesh here is a ``DeviceMesh`` over ranks of
that group with the axis names of the JAX package (``("frames",)`` or
``("frames", "code")``).  Each rank decodes its contiguous block of a chunk's
frame ids, which is what ``P("frames")`` places on each device.

Backends: NCCL where each rank has a card of its own, gloo on the CPU and
for ranks that share a card (NCCL refuses two ranks on one device).  gloo
does not move every CUDA tensor, so under gloo the collectives below stage a
CUDA tensor through host memory explicitly; under NCCL they run on the card.
A process with no group gets a one-rank group over its own device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from ..core.device import resolve_device

FRAME_AXIS = "frames"
CODE_AXIS = "code"


def _ensure_group(dev: torch.device) -> None:
    """A one-rank default group for a process that has none: NCCL for a
    CUDA device, gloo otherwise (an in-process store, no socket)."""
    if dist.is_initialized():
        return
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None else torch.cuda.current_device())
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)


def _mesh(device, ranks, names) -> DeviceMesh:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)  # the mesh keeps a device that is already chosen
    return DeviceMesh(dev.type, ranks, mesh_dim_names=names)


def default_mesh(devices: Optional[Sequence[int]] = None, axis_name: str = FRAME_AXIS,
                 device="cuda") -> DeviceMesh:
    """1-D mesh over every rank of the group (or over the given global ranks,
    which every rank of the group must name alike).  ``device`` is this
    process's device: a CUDA device (default) or ``"cpu"``.  Without a group,
    a one-rank group over ``device`` is made first."""
    _ensure_group(resolve_device(device))
    ranks = list(devices) if devices is not None else list(range(dist.get_world_size()))
    return _mesh(device, ranks, (axis_name,))


def multihost_mesh(axis_name: str = FRAME_AXIS, device="cuda") -> DeviceMesh:
    """Mesh over every rank of a multi-host group: initialise the group first
    (``torchrun`` with ``dist.init_process_group``), then every rank of every
    host is in it."""
    return default_mesh(None, axis_name, device)


@dataclass(frozen=True)
class Sharding:
    """Placements of a tensor's axes on a mesh, one per mesh axis (``Shard(d)``
    or ``Replicate()``), as ``NamedSharding`` places them in the JAX
    package."""

    mesh: DeviceMesh
    placements: tuple

    def local(self, tensor: torch.Tensor) -> torch.Tensor:
        """This rank's block of a global tensor."""
        coord = self.mesh.get_coordinate()
        for axis, p in enumerate(self.placements):
            if isinstance(p, Shard):
                size = self.mesh.size(axis)
                width = tensor.shape[p.dim] // size
                if width * size != tensor.shape[p.dim]:
                    raise ValueError(f"axis {p.dim} of {tuple(tensor.shape)} does not split "
                                     f"over {size} ranks")
                tensor = tensor.narrow(p.dim, coord[axis] * width, width)
        return tensor


def frame_sharding(mesh: DeviceMesh, axis_name: str = FRAME_AXIS) -> Sharding:
    """Shard the leading (frame) axis over ``axis_name``; replicate over the
    other mesh axes."""
    return Sharding(mesh, tuple(Shard(0) if n == axis_name else Replicate()
                                for n in mesh.mesh_dim_names))


def replicated_sharding(mesh: DeviceMesh) -> Sharding:
    return Sharding(mesh, (Replicate(),) * mesh.ndim)


def mesh_2d(frame_devices: int, code_devices: int, devices: Optional[Sequence[int]] = None,
            device="cuda") -> DeviceMesh:
    """2-D ``(frames, code)`` mesh: data parallelism over Monte-Carlo frames ×
    model parallelism over the code dimension (``code_sharded_decode``,
    ``code_sharded_polar_transform``)."""
    _ensure_group(resolve_device(device))
    ranks = list(devices) if devices is not None else list(range(dist.get_world_size()))
    if frame_devices * code_devices != len(ranks):
        raise ValueError(f"mesh {frame_devices}x{code_devices} != {len(ranks)} devices")
    grid = torch.tensor(ranks, dtype=torch.int).reshape(frame_devices, code_devices)
    return _mesh(device, grid, (FRAME_AXIS, CODE_AXIS))


def pad_to_multiple(n: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` that is ≥ n."""
    return ((n + multiple - 1) // multiple) * multiple


# -- collectives -----------------------------------------------------------------------

def _comm_device(tensor: torch.Tensor, group) -> torch.device:
    """Where a collective of ``group`` takes ``tensor``: host memory under
    gloo (a CUDA tensor is staged there), the card under NCCL."""
    if dist.get_backend(group) == "gloo":
        return torch.device("cpu")
    if tensor.device.type == "cuda":
        return tensor.device
    return torch.device("cuda", torch.cuda.current_device())


def all_gather_cat(tensor: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``tensor`` concatenated along ``dim`` in group-rank order."""
    t = tensor.to(_comm_device(tensor, group)).contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim).to(tensor.device)


def all_reduce(tensor: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The reduction of every rank's ``tensor`` (a new tensor)."""
    t = tensor.to(_comm_device(tensor, group), copy=True)
    dist.all_reduce(t, op=op, group=group)
    return t.to(tensor.device)


def send_to(tensor: torch.Tensor, peer: int, group) -> None:
    """Send to group rank ``peer`` (``recv_from`` on that rank receives it)."""
    dist.send(tensor.to(_comm_device(tensor, group)).contiguous(),
              dist.get_global_rank(group, peer), group=group)


def recv_from(like: torch.Tensor, peer: int, group) -> torch.Tensor:
    """A tensor shaped like ``like`` from group rank ``peer``."""
    buf = torch.empty(like.shape, dtype=like.dtype, device=_comm_device(like, group))
    dist.recv(buf, dist.get_global_rank(group, peer), group=group)
    return buf.to(like.device)


def mesh_barrier(mesh: DeviceMesh) -> None:
    """Wait for every rank of the mesh: a barrier over each axis's group in
    turn covers the whole grid."""
    for axis in range(mesh.ndim):
        dist.barrier(group=mesh.get_group(axis))


def is_mesh_root(mesh: Optional[DeviceMesh]) -> bool:
    """Whether this rank is the mesh's first (coordinate 0 on every axis); True
    without a mesh."""
    return mesh is None or all(c == 0 for c in mesh.get_coordinate())


# -- within-frame sharding ---------------------------------------------------------------

def code_sharded_decode(decode, mesh: DeviceMesh, frame_axis: str = FRAME_AXIS,
                        code_axis: str = CODE_AXIS):
    """``decode(llr [B, n]) → (bits [B, n], iters [B])`` of a quasi-cyclic
    LDPC decoder (``make_qc_bp_decoder`` or ``QCBPDecoder``) with the batch
    sharded over ``frame_axis`` and the codeword over ``code_axis``.

    Each rank keeps only its ``nb / code`` z-blocks of the channel LLRs and of
    the variable-side messages between iterations.  An iteration all-gathers
    the rolled blocks of the code group for the check update, and the
    early-stop syndrome is all-reduced, so the code ranks stop together.
    Outputs are bit-identical to the unsharded decoder: the arithmetic and its
    order are the same, only placement changes.

    Returns ``sharded(llr [B, n]) → (bits [B/f, n/c], iters [B/f])``: this
    rank's block of the global result.
    """
    build = getattr(decode, "qc_build", None) or getattr(
        getattr(decode, "_decode", None), "qc_build", None)
    if build is None:
        raise TypeError("code_sharded_decode takes a quasi-cyclic decoder "
                        "(make_qc_bp_decoder or QCBPDecoder)")
    sharding, group, rank, size = _frames_code(mesh, frame_axis, code_axis)
    local = build(CodeShard(rank, size, group))
    return lambda llr: local(sharding.local(torch.as_tensor(llr)))


def _frames_code(mesh: DeviceMesh, frame_axis: str, code_axis: str):
    """``(sharding P(frames, code), code group, rank in it, its size)``."""
    names = mesh.mesh_dim_names
    fa, ca = names.index(frame_axis), names.index(code_axis)
    sharding = Sharding(mesh, tuple(Shard(0) if i == fa else Shard(1) if i == ca
                                    else Replicate() for i in range(mesh.ndim)))
    return sharding, mesh.get_group(ca), mesh.get_local_rank(ca), mesh.size(ca)


@dataclass(frozen=True)
class CodeShard:
    """One rank's share of the code axis: its place in the code group and the
    collectives over that group."""

    rank: int
    size: int
    group: object

    def all_gather(self, tensor: torch.Tensor, dim: int) -> torch.Tensor:
        return all_gather_cat(tensor, self.group, dim)

    def all_reduce(self, tensor: torch.Tensor) -> torch.Tensor:
        return all_reduce(tensor, self.group)


def code_sharded_polar_transform(mesh: DeviceMesh, frame_axis: str = FRAME_AXIS,
                                 code_axis: str = CODE_AXIS):
    """Polar butterfly ``u [B, N] → x = u·F^⊗n`` with the code axis sharded:
    rank r of the code group holds positions ``[r·w, (r+1)·w)``, ``w = N /
    code``.  Stage s pairs ``j`` with ``j + 2^s``: stages with ``2^s < w``
    are local; in a wider stage rank r pairs with r ⊕ (2^s / w), the upper
    one sends its block and the lower one XORs it into its own.  Outputs are
    bit-identical to ``polar_transform``.

    Returns ``transform(u [B, N]) → x``: this rank's ``[B/f, w]`` int8 block
    of the global result.
    """
    from ..models.polar.encoder import polar_transform

    sharding, group, rank, size = _frames_code(mesh, frame_axis, code_axis)

    def transform(u):
        x = polar_transform(sharding.local(torch.as_tensor(u)))  # the stages within a shard
        peer_bit = 1
        while peer_bit < size:  # the stages wider than a shard
            peer = rank ^ peer_bit
            if rank & peer_bit:
                send_to(x, peer, group)
            else:
                x ^= recv_from(x, peer, group)
            peer_bit <<= 1
        return x

    return transform
