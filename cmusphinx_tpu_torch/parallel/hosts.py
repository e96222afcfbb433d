"""Multi-process entry point + corpus partitioning.

Port of `cmusphinx_tpu/parallel/hosts.py` (`HostInfo`, `init_distributed`,
`partition_ctl`, `local_partition`) onto `torch.distributed`.  The
reference distributes work the way SphinxTrain does (N `bw -part i -npart
N` processes, SphinxTrain bw/main.c:492-497 corpus_set_partition), with
the accumulator reduce as a collective instead of `norm` over files.  Here
a run of N processes (one a card, or gloo ranks on the CPU) joins one
process group; each takes its `-part`/`-npart` share of the control file
(`local_partition`), and the reduces are `all_reduce`s over NCCL between
cards or gloo on the CPU.

A single process is the documented no-op: with no coordinator and no world
size above 1, `init_distributed` returns process 0 of 1, uninitialized, so
every entry point works unchanged on one machine.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch


@dataclass
class HostInfo:
    process_id: int
    num_processes: int
    initialized: bool   # True when a torch.distributed group is up

    @property
    def is_primary(self) -> bool:
        return self.process_id == 0


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     device: torch.device | str = "cuda") -> HostInfo:
    """Join (or skip) the multi-process run.

    Explicit arguments win; otherwise torchrun's environment is read:
    `MASTER_ADDR` / `MASTER_PORT` (the coordinator, "host:port"),
    `WORLD_SIZE` and `RANK` (where the reference reads
    JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID).  The
    backend is NCCL for a CUDA `device` (each process then takes the card
    `LOCAL_RANK`, else its rank, modulo the cards it sees) and gloo for the
    CPU.  Returns the process's identity; a group already up is joined as
    it is, and a single process is a no-op (process 0 of 1)."""
    import torch.distributed as dist

    if dist.is_initialized():
        return HostInfo(dist.get_rank(), dist.get_world_size(), True)
    if coordinator is None and os.environ.get("MASTER_ADDR"):
        coordinator = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ.get('MASTER_PORT') or 29500}")
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    if coordinator is None and (num_processes is None or num_processes <= 1):
        return HostInfo(process_id=0, num_processes=1, initialized=False)
    if coordinator is None:
        raise ValueError(f"{num_processes} processes but no coordinator: "
                         f"give one, or set MASTER_ADDR and MASTER_PORT")
    num_processes = num_processes or 1
    process_id = process_id or 0
    cuda = torch.device(device).type == "cuda"
    if cuda:
        local = _env_int("LOCAL_RANK")
        torch.cuda.set_device((process_id if local is None else local)
                              % torch.cuda.device_count())
    if "://" not in coordinator:
        coordinator = "tcp://" + coordinator
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=coordinator,
                            world_size=num_processes, rank=process_id)
    return HostInfo(process_id=dist.get_rank(),
                    num_processes=dist.get_world_size(), initialized=True)


def partition_ctl(items: Sequence, part: int, npart: int) -> List:
    """The bw/sphinx3 `-part i -npart N` ctl split (corpus.c
    corpus_set_partition: contiguous blocks, remainder spread over the
    first parts; 1-based part ids like the reference flags)."""
    if not (1 <= part <= npart):
        raise ValueError(f"part must be in [1, {npart}], got {part}")
    n = len(items)
    base, rem = divmod(n, npart)
    sizes = [base + (1 if i < rem else 0) for i in range(npart)]
    lo = sum(sizes[: part - 1])
    return list(items[lo : lo + sizes[part - 1]])


def local_partition(items: Sequence, info: Optional[HostInfo] = None) -> List:
    """This process's share of a work list: process i of N takes
    partition i+1 of N (by default the running group's, else all of
    it)."""
    if info is None:
        import torch.distributed as dist
        info = (HostInfo(dist.get_rank(), dist.get_world_size(), True)
                if dist.is_initialized() else HostInfo(0, 1, False))
    return partition_ctl(items, info.process_id + 1, info.num_processes)
