"""Multi-process initialization and its allreduce smoke.

Counterpart of ``mvil_fusion_tpu/parallel/distributed.py``.  There,
`jax.distributed.initialize` joins the hosts and the global device set
forms the mesh; here `init` joins the processes in a `torch.distributed`
process group, and each process's mesh of local shards joins that group
(`mesh.make_mesh(..., group=...)`), so that `mesh.psum` adds every
process's partials.

Run on each process:

    python -m mvil_fusion_torch.parallel.distributed \
        --coordinator=<host0>:<port> --num-processes=N --process-id=k \
        [--local-shards=n] [--device cpu]

`--device` takes the place of the reference's `--platform`: the mesh's
shards sit on the card unless it says otherwise.  Without it, one process
takes every visible card, and each of several processes takes one card,
that of its process id modulo the host's cards (NCCL refuses two processes
on one card).  The backend is named,
never swapped silently: NCCL for a mesh on cards, gloo for one on the CPU,
unless `backend` says otherwise (gloo also reduces CUDA tensors, through
the host, where NCCL refuses two processes on one card).
"""

from __future__ import annotations

import argparse
from datetime import timedelta

import torch
import torch.distributed as dist

from mvil_fusion_torch.parallel import mesh as mesh_lib
from mvil_fusion_torch.utils.device import resolve_device

TIMEOUT = timedelta(seconds=120)


def init(coordinator: str | None = None, num_processes: int = 1,
         process_id: int = 0, backend: str | None = None,
         device: torch.device | str | None = None):
    """Join `num_processes` processes through the TCP store at
    `coordinator` ("host:port"); returns the process group, or None for a
    single process without a coordinator.  `backend` defaults to the one
    for `device` (the card unless the caller asks for the CPU)."""
    if coordinator is None and num_processes == 1:
        return None
    if coordinator is None:
        raise ValueError(f"{num_processes} processes need a coordinator")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT)
    return dist.group.WORLD


def local_devices(device: torch.device | str | None, num_processes: int,
                  process_id: int, local_shards: int | None = None,
                  n_cards: int | None = None):
    """This process's shards: `local_shards` (default 2) on `device` where
    it is named; else, for one of several processes, `local_shards`
    (default 1) on its card, ``cuda:<process_id mod n_cards>``; else None,
    one shard per visible card (`mesh.make_mesh`'s default).  `n_cards`
    defaults to the visible cards, and without a card that raises."""
    if device is not None:
        return [torch.device(device)] * (local_shards or 2)
    if num_processes == 1:
        return None
    if n_cards is None:
        resolve_device(None)
        n_cards = torch.cuda.device_count()
    return [torch.device("cuda", process_id % n_cards)] * (local_shards or 1)


def smoke(n_local: int | None = None,
          devices: list[torch.device | str] | None = None) -> int:
    """Allreduce smoke over the global mesh (after `init`, or in one
    process): each global shard holds its index, and the sum over the mesh
    must be n(n−1)/2.  Returns n, the mesh's global size."""
    group = dist.group.WORLD if dist.is_initialized() else None
    mesh = mesh_lib.make_mesh(n_local, devices=devices, group=group)
    parts = [torch.full((), float(mesh.offset + k), device=dev)
             for k, dev in enumerate(mesh.devices)]
    total = float(mesh_lib.psum(mesh, parts))
    n = mesh.size
    expect = n * (n - 1) / 2
    if total != expect:
        raise RuntimeError(f"allreduce over {n} shards gave {total}, "
                           f"expected {expect}")
    return n


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--local-shards", type=int, default=None,
                    help="shards of this process (default: one per card "
                    "for one process, one on its card for each of several; "
                    "with --device, 2 on that device)")
    ap.add_argument("--device", default=None,
                    help="where the shards sit (default: the card)")
    ap.add_argument("--backend", default=None,
                    help="nccl or gloo (default: by --device)")
    args = ap.parse_args(argv)
    devices = local_devices(args.device, args.num_processes,
                            args.process_id, args.local_shards)
    dev = devices[0] if devices else resolve_device(None)
    group = init(args.coordinator, args.num_processes, args.process_id,
                 args.backend, dev)
    try:
        n = smoke(args.local_shards, devices)
        backend = dist.get_backend() if group is not None else "none"
        print(f"process {args.process_id}: {n} global shards "
              f"({args.num_processes} processes, backend {backend})")
        print(f"allreduce smoke over {n} shards OK", flush=True)
    finally:
        if group is not None:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
