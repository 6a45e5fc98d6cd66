"""A one-dimensional mesh of shards for the sharded solvers.

Counterpart of ``mvil_fusion_tpu/parallel/mesh.py``.  JAX's mesh is
single-controller: one process drives every device, a `shard_map` runs the
same program on each device's block of a sharded axis and a `psum` sums
the devices' partials.  The port keeps that shape: one process holds an
ordered tuple of devices, one per shard; a solver queues each shard's work
on that shard's device and `psum` adds the partials.  A device may repeat,
so that n shards sit on one card as JAX's virtual CPU devices sit on one
CPU.  A mesh can also span processes (`distributed.init`): its process
group then adds every process's local sum with one `all_reduce`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from mvil_fusion_torch.utils.device import resolve_device


class Mesh(NamedTuple):
    """The shards of one axis.  `devices` are this process's shards, in
    order; with a `group` of W processes each of them holds as many, and
    this process's shards are the global shards rank·n … rank·n + n − 1."""

    devices: tuple[torch.device, ...]
    axis: str = "f"
    group: Optional[dist.ProcessGroup] = None

    @property
    def local_size(self) -> int:
        return len(self.devices)

    @property
    def size(self) -> int:
        """Shards over every process of the mesh."""
        return self.local_size * self.processes

    @property
    def processes(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def offset(self) -> int:
        """The global index of this process's first shard."""
        return 0 if self.group is None else \
            dist.get_rank(self.group) * self.local_size

    @property
    def first(self) -> torch.device:
        """Where the replicated values live: the first shard's device."""
        return self.devices[0]


def make_mesh(n_devices: int | None = None, axis: str = "f",
              devices: Sequence[torch.device | str] | None = None,
              group: Optional[dist.ProcessGroup] = None) -> Mesh:
    """A mesh over the first `n_devices` of `devices` (default: all of
    them).  `devices` defaults to every visible CUDA device, and without
    a card that raises RuntimeError: a CPU mesh is one the caller asks
    for, e.g. ``devices=["cpu"] * 8``.  `group` joins the meshes of
    several processes, each with the same number of shards."""
    if devices is None:
        resolve_device(None)
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = tuple(torch.device(d) for d in devices)
    if n_devices is not None:
        if not 1 <= n_devices <= len(devices):
            raise ValueError(f"a mesh of {n_devices} shards over "
                             f"{len(devices)} devices")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    mesh = Mesh(devices, axis, group)
    if group is not None:
        counts = [None] * mesh.processes
        dist.all_gather_object(counts, mesh.local_size, group=group)
        if len(set(counts)) != 1:
            raise ValueError(f"the processes hold {counts} shards: a mesh "
                             f"needs as many in each")
    return mesh


def mesh_from_config(cfg, devices: Sequence[torch.device | str] | None = None,
                     group: Optional[dist.ProcessGroup] = None) -> Mesh:
    """The mesh of a `config.ParallelConfig`: its first axis,
    ``mesh_shape[0]`` shards named ``mesh_axes[0]``."""
    if len(cfg.mesh_shape) != 1 or len(cfg.mesh_axes) != 1:
        raise ValueError(f"a one-dimensional mesh, not {cfg.mesh_shape} "
                         f"over {cfg.mesh_axes}")
    return make_mesh(cfg.mesh_shape[0], cfg.mesh_axes[0], devices, group)


def shard(x: torch.Tensor, mesh: Mesh, dim: int = 0
          ) -> tuple[torch.Tensor, ...]:
    """This process's blocks of `x` along `dim`, each on its shard's
    device: contiguous blocks of equal length in shard order, as JAX's
    ``P(axis)`` lays them out.  A length that the mesh's size does not
    divide is an error (pad with masked slots)."""
    n = x.shape[dim]
    if n % mesh.size:
        raise ValueError(f"an axis of {n} does not divide into "
                         f"{mesh.size} shards (pad with masked slots)")
    block = n // mesh.size
    return tuple(
        x.narrow(dim, (mesh.offset + k) * block, block).to(
            dev, non_blocking=True)
        for k, dev in enumerate(mesh.devices))


def replicate(x: torch.Tensor, mesh: Mesh) -> tuple[torch.Tensor, ...]:
    """`x` on every shard's device; one tensor where they are the same
    device, so no copy is made on one card."""
    copies: dict[torch.device, torch.Tensor] = {}
    for dev in mesh.devices:
        if dev not in copies:
            copies[dev] = x.to(dev, non_blocking=True)
    return tuple(copies[dev] for dev in mesh.devices)


def psum(mesh: Mesh, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum of the shards' partials (one per local shard, each on its
    shard's device), added in shard order on the mesh's first device, then
    over the mesh's processes.  The result stands for the replicated value
    of every shard.

    A partial on another card is copied with ``.to``, which orders the copy
    after the work queued on both cards' current streams (PyTorch's copy
    between devices waits for each side with an event), so the sum needs
    no wait of its own.  On one card nothing is copied."""
    if len(parts) != mesh.local_size:
        raise ValueError(f"{len(parts)} partials for {mesh.local_size} "
                         f"shards")
    total = parts[0].to(mesh.first)
    for part in parts[1:]:
        total = total + part.to(mesh.first, non_blocking=True)
    if mesh.group is not None and mesh.processes > 1:
        if total is parts[0]:
            total = total.clone()
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=mesh.group)
    return total
