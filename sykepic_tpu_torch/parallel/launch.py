"""Starting and joining the process group: one process per card.

- Under ``torchrun`` the group comes from its environment (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``).
- Otherwise from a ``FileStore`` path with an explicit rank and world size:
  what :func:`spawn` and the tests use (no network, and parallel test
  workers must not share TCP ports).

The backend is NCCL for ``cuda`` (each rank on ``cuda:LOCAL_RANK``) and
gloo for ``cpu``. A failed initialisation raises: nothing goes on quietly
with fewer ranks or on another device.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist

from .. import device as device_mod


def launched_by_torchrun() -> bool:
    """Whether the environment describes a group of more than one rank."""
    return "RANK" in os.environ and int(os.environ.get("WORLD_SIZE", "1")) > 1


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    """This process's rank, 0 without a group."""
    return dist.get_rank() if is_initialized() else 0


def init_process_group(device="cuda", store_path=None, rank: int | None = None,
                       world_size: int | None = None,
                       local_rank: int | None = None) -> torch.device:
    """Join the process group and return this rank's device: ``cuda:<local
    rank>`` under NCCL (raises without a card), ``cpu`` under gloo. With
    ``store_path`` the group meets at a ``FileStore`` there (``rank`` and
    ``world_size`` required); without it, at torchrun's environment."""
    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if store_path is None:
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        kwargs = {"init_method": "env://"}
    else:
        if rank is None or world_size is None:
            raise ValueError("a FileStore group needs rank and world_size")
        local_rank = rank if local_rank is None else local_rank
        kwargs = {"store": dist.FileStore(str(store_path), world_size)}
    if dev.type == "cuda":
        device_mod.resolve("cuda")  # raises without a card
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {rank} wants cuda:{local_rank}, but "
                f"{torch.cuda.device_count()} card(s) are visible")
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
        kwargs["device_id"] = dev
    else:
        dev = device_mod.resolve("cpu")
    dist.init_process_group(backend, rank=rank, world_size=world_size,
                            **kwargs)
    return dev


def destroy_process_group() -> None:
    if is_initialized():
        dist.destroy_process_group()


def barrier() -> None:
    """Wait for every rank (nothing without a group)."""
    if is_initialized():
        dist.barrier()


def _entry(index, fn, store_path, nprocs, device, args):
    dev = init_process_group(device, store_path, index, nprocs)
    try:
        fn(dev, *args)
    finally:
        destroy_process_group()


def spawn(fn, nprocs: int, device="cuda", args=()) -> None:
    """Run ``fn(device, *args)`` in ``nprocs`` new processes, rank ``i``
    on ``cuda:i`` (or the CPU), joined by a ``FileStore`` in a fresh
    temporary directory; returns when all have finished and raises if one
    failed. ``fn`` must be importable (the processes start fresh)."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="sykepic-group-") as tmp:
        mp.start_processes(_entry, args=(fn, str(Path(tmp) / "store"),
                                         nprocs, str(device), tuple(args)),
                           nprocs=nprocs, join=True, start_method="spawn")
