"""Process-group start-up: one process per rank.

Counterpart of otto_tpu/parallel/distributed.py. otto_tpu starts
jax.distributed for a multi-host run; the port starts a torch.distributed
process group, from torchrun's environment (RANK, WORLD_SIZE,
MASTER_ADDR, MASTER_PORT), from explicit arguments, or from a FileStore
(tests and `spawn_ranks`, which use no port).

The backend follows the device and is never switched behind the caller's
back: gloo for CPU ranks; NCCL when every rank of a host has a card of its
own; gloo when ranks share a card (NCCL refuses two ranks on one device).
A CUDA rank runs on cuda:<local rank>, or, sharing, on cuda:<local rank %
cards>. A failed start raises.
"""
from __future__ import annotations

import logging
import os
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from otto_tpu_torch.parallel.mesh import MeshContext, make_mesh, set_rank_device

log = logging.getLogger(__name__)


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def local_rank(rank: Optional[int] = None) -> int:
    """torchrun's LOCAL_RANK, else `rank` (or the process group's)."""
    env = _env_int("LOCAL_RANK")
    if env is not None:
        return env
    if rank is not None:
        return rank
    return dist.get_rank() if dist.is_initialized() else 0


def local_world_size() -> int:
    return _env_int("LOCAL_WORLD_SIZE") or (
        dist.get_world_size() if dist.is_initialized() else 1)


def pick_backend(device) -> str:
    """gloo for the CPU; for CUDA, NCCL when this host has a card for each
    of its ranks, else gloo (ranks sharing a card)."""
    if torch.device(device).type != "cuda":
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= local_world_size() else "gloo"


def rank_device(device, backend: str, rank: Optional[int] = None) -> torch.device:
    """This rank's device for a requested 'cpu' / 'cuda' (an explicit
    'cuda:N' is kept)."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    idx = local_rank(rank)
    if backend != "nccl":
        idx %= torch.cuda.device_count()
    return torch.device("cuda", idx)


def init_distributed(
    device="cuda",
    backend: Optional[str] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    store_path: Optional[str] = None,
) -> Optional[torch.device]:
    """Start this process's rank. rank / world_size default to torchrun's
    RANK / WORLD_SIZE (its MASTER_ADDR / MASTER_PORT give the rendezvous);
    with `store_path` the ranks meet in a FileStore there instead. Without
    either, a single process: no-op, returns None. Otherwise returns this
    rank's device (set as the current CUDA device, and the default device
    of make_mesh / global_mesh)."""
    rank = _env_int("RANK") if rank is None else rank
    world_size = _env_int("WORLD_SIZE") if world_size is None else world_size
    if rank is None and world_size is None:
        log.info("single process; torch.distributed not initialised")
        return None
    if rank is None or world_size is None:
        raise ValueError(f"init_distributed: rank={rank}, world_size={world_size}")
    backend = backend or pick_backend(device)
    dev = rank_device(device, backend, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        if store_path is not None:
            store = dist.FileStore(store_path, world_size)
            dist.init_process_group(backend, store=store, rank=rank,
                                    world_size=world_size)
        else:
            dist.init_process_group(backend, init_method="env://", rank=rank,
                                    world_size=world_size)
    set_rank_device(dev)
    log.info("torch.distributed: rank %d/%d, backend %s, device %s", rank,
             world_size, backend, dev)
    return dev


def global_mesh(model_parallel: int = 1, device=None) -> MeshContext:
    """(data, model) mesh over every rank. A model-axis row must stay on
    one host, so model_parallel must divide the ranks of a host."""
    local = local_world_size()
    if model_parallel > 1 and local % model_parallel != 0:
        raise ValueError(
            f"model_parallel={model_parallel} must divide local device count "
            f"{local} to keep table shards on one host")
    return make_mesh(model_parallel=model_parallel, device=device)


def _rank_main(rank: int, fn: Callable, world: int, store_path: str, device,
               backend: Optional[str], threads: int, args: Sequence) -> None:
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(world)
    if threads:
        torch.set_num_threads(threads)
    init_distributed(device, backend, rank=rank, world_size=world, store_path=store_path)
    try:
        fn(rank, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, world: int, args: Sequence = (), device="cpu",
                backend: Optional[str] = None, store_path: Optional[str] = None,
                threads: int = 0) -> None:
    """Run fn(rank, *args) in `world` fresh processes (the spawn method: a
    process that has used CUDA cannot fork), each a started rank meeting
    in a FileStore at `store_path`. `fn` must be importable by module name
    (not a lambda); `threads` > 0 sets each rank's intra-op threads. Raises
    when any rank fails."""
    import tempfile

    import torch.multiprocessing as mp

    if store_path is None:
        fd, store_path = tempfile.mkstemp(prefix="otto-ranks-")
        os.close(fd)
        os.remove(store_path)
    mp.start_processes(_rank_main, args=(fn, world, store_path, device, backend, threads,
                                         tuple(args)),
                       nprocs=world, start_method="spawn", join=True)
