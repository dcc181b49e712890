"""Process-group start-up and rank-gated utilities.

Counterpart of `matten_tpu/parallel/distributed.py`. Where the JAX package
calls `jax.distributed.initialize` and runs one program over every device,
the port runs one process per rank and joins them with
`torch.distributed.init_process_group`. `initialize_distributed` reads
torchrun's environment (`RANK`, `WORLD_SIZE`, `MASTER_ADDR`, `MASTER_PORT`)
or takes the address, world size and rank from its caller; the group
always gets a finite timeout, so a rank that dies fails the others' next
collective within it instead of hanging them.

The backend is the caller's choice: `nccl` for ranks on CUDA devices and
`gloo` for the CPU by default, and `gloo` on CUDA tensors when the caller
names it (ranks that share one card: NCCL refuses two ranks on one
device). It is never switched behind the caller's back. A rank of an
`nccl` group is bound to its card before it joins: the current device is
set and the group gets it as `device_id`, `cuda:LOCAL_RANK` unless the
caller names another, so a barrier or a point-to-point op never guesses
the device from the global rank.

`TIMEOUT_S` bounds the collectives of a step. A wait on one rank's host
work (the data setup, a checkpoint write) is as long as that work, and
goes through the mesh's host group instead (`Mesh.barrier`, `HOST_WAIT_S`).
"""

from __future__ import annotations

import datetime
import functools
import logging
import os
from typing import Callable, Optional, Union

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

__all__ = [
    "initialize_distributed",
    "is_primary_host",
    "rank_zero_only",
    "make_multihost_mesh",
    "world_size",
    "TIMEOUT_S",
    "HOST_WAIT_S",
]

# a collective waits this long for a missing rank before it raises
TIMEOUT_S = 60.0
# a wait on one rank's host work waits this long: a rank that dies ends the
# world through its launcher (torchrun, `parallel.launch`), not through it
HOST_WAIT_S = 24 * 3600.0


def initialize_distributed(
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    device: Union[str, torch.device, None] = None,
) -> bool:
    """Join the default process group; True when one is up afterwards.

    Without arguments it reads torchrun's environment; with neither that
    nor an `init_method` (e.g. "tcp://localhost:29500" or "file:///path")
    a world of one process stays single-process (False), and a larger one
    raises. `backend` defaults to "nccl" when `device` is a CUDA device
    and to "gloo" otherwise. Under nccl the rank's card is `device`, or
    `cuda:LOCAL_RANK` when `device` is None or names no index (torchrun's
    ranks on one host); the current device is set to it and the group is
    bound to it (`device_id`). A CUDA device under gloo is made current
    too. A group that is already up is kept."""
    if dist.is_initialized():
        return True
    env = os.environ
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None else int(world_size)
    rank = int(env.get("RANK", 0)) if rank is None else int(rank)
    if init_method is None:
        if "MASTER_ADDR" in env:
            init_method = "env://"
        elif world_size == 1:
            logger.info("single-process run: no process group")
            return False
        else:
            raise ValueError(
                f"world size {world_size} but no init_method and no MASTER_ADDR: launch the "
                "ranks with torchrun, or pass init_method, world_size and rank"
            )
    device = None if device is None else torch.device(device)
    if backend is None:
        backend = "nccl" if device is not None and device.type == "cuda" else "gloo"
    bound = {}
    if backend == "nccl":
        if device is not None and device.type != "cuda":
            raise ValueError(f"the nccl backend runs on CUDA devices, not {device}")
        if device is None or device.index is None:
            device = torch.device("cuda", int(env.get("LOCAL_RANK", 0)))
        bound["device_id"] = device
    if device is not None and device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend,
        init_method=init_method,
        world_size=world_size,
        rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S),
        **bound,
    )
    logger.info("process group: rank %d of %d, backend %s, device %s", rank, world_size, backend, device)
    return True


def world_size() -> int:
    """The default group's size (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary_host() -> bool:
    """Rank 0 of the default group; without one, torchrun's RANK (0 when
    unset), so a script can ask before it joins the group."""
    if dist.is_initialized():
        return dist.get_rank() == 0
    return int(os.environ.get("RANK", 0)) == 0


def rank_zero_only(fn: Callable) -> Callable:
    """Run `fn` only on the primary rank (checkpoint writes, logging)."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if is_primary_host():
            return fn(*args, **kwargs)
        return None

    return wrapped


def make_multihost_mesh(n_graph: int = 1):
    """('data', 'graph') mesh over every rank of the default group, data
    outermost: ranks g, g + n_graph, ... share a data group, so only the
    gradient reduction crosses hosts when a host holds a graph group."""
    from matten_tpu_torch.parallel.sharding import make_mesh

    return make_mesh(n_data=world_size() // n_graph, n_graph=n_graph)
