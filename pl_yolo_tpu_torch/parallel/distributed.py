"""Process set-up, per-host data sharding and the evaluation's gather (port
of `pl_yolo_tpu/parallel/distributed.py`).

Under torchrun every rank reads `RANK`, `WORLD_SIZE`, `LOCAL_RANK`,
`LOCAL_WORLD_SIZE` and `MASTER_ADDR` / `MASTER_PORT` from its environment;
`initialize()` joins the process group and is a no-op (world 1) without
them. The backend follows a rule, which it prints:

  * `nccl` when each rank of a host has a card of its own;
  * `gloo` on the CPU, and when the ranks of a host share a card: NCCL will
    not put two ranks of one communicator on one device. gloo takes CUDA
    tensors for all-reduce and broadcast; `collectives` stages its other
    ops through host memory.

A rank on the card takes `cuda:{LOCAL_RANK % device_count}`.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

# the ranks on this host, as `initialize` was told
_LOCAL_WORLD = [1]


def env_ranks() -> tuple[int, int, int, int]:
    """(rank, world, local rank, local world) from torchrun's environment;
    (0, 1, 0, 1) without it."""
    world = int(os.environ.get("WORLD_SIZE", 1))
    rank = int(os.environ.get("RANK", 0))
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return rank, world, local_rank, local_world


def choose_backend(device: torch.device, local_world: int) -> str:
    """`nccl` when each of a host's `local_world` ranks has a card of its
    own, else `gloo` (the CPU, or ranks sharing a card)."""
    if device.type != "cuda":
        return "gloo"
    if local_world > torch.cuda.device_count():
        return "gloo"
    return "nccl"


def rank_device(device=None) -> torch.device:
    """The device of this rank: `cuda:{LOCAL_RANK % device_count}` for the
    card (None or "cuda"), else the device asked for."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        local_rank = env_ranks()[2]
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
    return device


def initialize(device=None, init_method: str | None = None,
               rank: int | None = None, world_size: int | None = None,
               local_world_size: int | None = None) -> tuple[int, int]:
    """Join the process group if there is more than one process, or if
    `init_method` names one (a world of 1 over NCCL, say); returns (rank,
    world). Without torchrun's environment and without arguments it is a
    no-op. The backend follows the module's rule and is printed."""
    env_rank, env_world, _, env_local = env_ranks()
    rank = env_rank if rank is None else rank
    world = env_world if world_size is None else world_size
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if world == 1 and init_method is None:
        return 0, 1
    local_world = (local_world_size if local_world_size is not None
                   else (env_local if world_size is None else world))
    device = rank_device(device)
    backend = choose_backend(device, local_world)
    _LOCAL_WORLD[0] = local_world
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world)
    print(f"[parallel] rank {rank} of {world} on {device}: backend "
          f"{backend} ({local_world} ranks on this host, "
          f"{torch.cuda.device_count() if device.type == 'cuda' else 0} "
          "cards)", flush=True)
    return rank, world


def world() -> tuple[int, int]:
    """(rank, world) of the process group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shard_info() -> tuple[int, int]:
    """(shard id, number of shards) for per-process evaluation sharding."""
    return world()


def host_info() -> tuple[int, int, int, int]:
    """(host index, number of hosts, rank on the host, ranks on the host):
    the ranks of a host are consecutive, as many as `initialize` was told
    (torchrun's `LOCAL_WORLD_SIZE`)."""
    rank, size = world()
    local = min(_LOCAL_WORLD[0], size)
    if size % local:
        local = size
    return rank // local, size // local, rank % local, local


def all_gather_host(values) -> list:
    """Every rank's picklable `values`, in rank order, on every rank
    (`all_gather_object`); [values] in one process."""
    rank, size = world()
    if size == 1:
        return [values]
    out = [None] * size
    dist.all_gather_object(out, values)
    return out


class StopFlag:
    """Agreement on a flag that any rank may raise (a SIGTERM), at one step
    on every rank, without waiting for the card: the flags are summed on
    the host, over a gloo group of the world (built here, so every rank
    makes its `StopFlag` at the same point), and each `vote` starts the
    sum of this step's flag and reads the one the step before started.
    So every rank stops at the same step, the one after the flag was first
    raised; the host waits only for the other ranks' previous vote."""

    def __init__(self):
        self.group = dist.new_group(backend="gloo")
        self._flag = torch.zeros(1)
        self._work = None

    def vote(self, flag: bool) -> bool:
        """Cast this step's flag; True on every rank at the same step once
        a rank cast True at the step before."""
        stop = self.settle()
        self._flag = torch.tensor([float(flag)])
        self._work = dist.all_reduce(self._flag, group=self.group,
                                     async_op=True)
        return stop

    def settle(self) -> bool:
        """Wait for the vote in flight, if any: whether a rank cast True."""
        work, self._work = self._work, None
        if work is None:
            return False
        work.wait()
        return bool(self._flag.item() > 0)


def is_main_process() -> bool:
    return world()[0] == 0


def shutdown() -> None:
    """Leave the process group (each rank, at its end)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
