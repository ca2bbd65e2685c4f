"""Multi-process execution: N ``torch.distributed`` ranks share the loci.

Port of ``bpp_tpu/parallel/multihost.py``.  The reference has no
multi-machine story (its parallelism tops out at one host's pthreads,
src/threads.c); ``bpp_tpu`` forms one JAX cluster and lets XLA shard the
locus axis over the global mesh.  Here N processes form one
``torch.distributed`` group, each parses the same control file and data,
keeps one contiguous block of loci (``parallel.mesh``), and runs K1 (K2
for diploid data) on its block; every cross-locus quantity is
all-reduced.

Usage (one command a process):

  python -m bpp_tpu_torch --cfile run.ctl \\
      --multihost <host:port>,<num_processes>,<process_id>

or ``--multihost auto`` under a launcher that sets torch's own
``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``
(``env://``, as ``torchrun`` does).  The backend is NCCL when every rank
has a card of its own and gloo on the CPU or when ranks share a card
(NCCL refuses two ranks on one GPU).
"""

from __future__ import annotations

import dataclasses
import os
import sys

import torch


@dataclasses.dataclass(frozen=True)
class MultihostSpec:
    coordinator: str | None
    num_processes: int | None
    process_id: int | None

    @classmethod
    def parse(cls, arg: str) -> "MultihostSpec":
        """Parse '--multihost host:port,N,i' (or 'auto' for env vars)."""
        if arg.strip().lower() == "auto":
            return cls(None, None, None)
        parts = arg.split(",")
        if len(parts) != 3:
            raise ValueError(
                "--multihost expects 'coordinator:port,num_processes,"
                "process_id' or 'auto'")
        return cls(parts[0].strip(), int(parts[1]), int(parts[2]))


def _local_index(rank: int, n_dev: int) -> int:
    """The card of this rank: ``LOCAL_RANK`` (a launcher's) or the rank
    modulo the cards this host sees."""
    local = os.environ.get("LOCAL_RANK")
    return int(local) if local is not None else rank % max(n_dev, 1)


def init_multihost(spec: MultihostSpec, device="cuda",
                   quiet: bool = False) -> torch.device:
    """``torch.distributed.init_process_group`` for this process, and its
    device: ``cuda:{LOCAL_RANK or rank % device_count}`` unless ``device``
    asks for the CPU.  A missing GPU is an error (``driver.resolve_
    device``).  The backend is NCCL when this host has a card for each of
    its ranks (``LOCAL_WORLD_SIZE``, else the world size), else gloo;
    rank 0 prints it on stderr."""
    import torch.distributed as dist

    from ..mcmc.driver import resolve_device

    if spec.coordinator is None:
        rank = int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
        url = "env://"
    else:
        rank, world = spec.process_id, spec.num_processes
        if not 0 <= rank < world:
            raise ValueError(f"--multihost: process id {rank} is not in "
                             f"0..{world - 1}")
        url = f"tcp://{spec.coordinator}"
    dev = resolve_device(device)
    backend = "gloo"
    if dev.type == "cuda":
        n_dev = torch.cuda.device_count()
        dev = torch.device("cuda", _local_index(rank, n_dev))
        torch.cuda.set_device(dev)
        # NCCL needs a card a rank: ranks that share one take gloo
        if int(os.environ.get("LOCAL_WORLD_SIZE", world)) <= n_dev:
            backend = "nccl"
    dist.init_process_group(backend, init_method=url, world_size=world,
                            rank=rank)
    if rank == 0 and not quiet:
        print(f"bpp_tpu_torch multihost: {world} processes, backend "
              f"{backend}, rank 0 on {dev}", file=sys.stderr)
    return dev


def shutdown():
    """Leave the process group (a no-op without one)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
