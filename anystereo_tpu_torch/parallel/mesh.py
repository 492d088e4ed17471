"""The process mesh over `torch.distributed` (the JAX package's
`parallel/mesh.py`).

The JAX package puts its devices on a mesh with a `data` axis (the batch,
gradients reduced by the psum XLA inserts) and a `spatial` axis (H-tiling
for high-resolution inference).  The port runs one process a card ("rank"):
on the data axis each rank has the same model and its own slice of the
batch, the gradients summed over the ranks after the backward
(`train/step.py`); on the spatial axis the ranks of a group each hold a tile
of the frame's rows (`parallel/spatial.py`, inference only).  `make_mesh`
lays the world out as the JAX package's `make_mesh` lays out its devices:
rank r sits at (r // spatial, r % spatial) of a data x spatial grid.

Bring-up (`maybe_initialize_distributed`) takes either environment:

  * the JAX package's: `COORDINATOR_ADDRESS` (host:port), `NUM_PROCESSES`,
    `PROCESS_ID`;
  * torchrun's: `MASTER_ADDR`, `MASTER_PORT`, `RANK`, `WORLD_SIZE`,
    `LOCAL_RANK`.

A rank's card is `cuda:LOCAL_RANK` (0 where `LOCAL_RANK` is unset: one
process a host, as the JAX contract has it).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from anystereo_tpu_torch.config import MeshConfig
from anystereo_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)


def backend_for(device: Union[str, torch.device]) -> str:
    """The process group's backend for ranks that train on `device`:
    `nccl` when every rank has its own card, `gloo` on the CPU."""
    return "gloo" if torch.device(device).type == "cpu" else "nccl"


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", 0))


def _cluster_env() -> Optional[Tuple[str, int, int]]:
    """(init_method, world size, rank) from the environment, or None when
    neither contract is set."""
    env = os.environ
    if "COORDINATOR_ADDRESS" in env:
        missing = [k for k in ("NUM_PROCESSES", "PROCESS_ID") if k not in env]
        if missing:
            raise RuntimeError(f"COORDINATOR_ADDRESS is set but {missing} are not: torch.distributed "
                               "cannot detect a cluster by itself")
        return f"tcp://{env['COORDINATOR_ADDRESS']}", int(env["NUM_PROCESSES"]), int(env["PROCESS_ID"])
    if "MASTER_ADDR" in env and "WORLD_SIZE" in env:
        return "env://", int(env["WORLD_SIZE"]), int(env["RANK"])
    return None


def maybe_initialize_distributed(require: bool = False, device: Union[str, torch.device] = "cuda") -> bool:
    """Initialise the default process group from the cluster environment
    (see the module docstring), with the backend `backend_for(device)`.
    A no-op when a group is already initialised.  Returns whether the world
    is larger than one process.  Without a cluster environment, or when the
    initialisation fails, it returns False, or raises with `require`."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    try:
        found = _cluster_env()
    except RuntimeError:
        if require:
            raise
        log.warning("incomplete cluster environment; running as a single process", exc_info=True)
        return False
    if found is None:
        if require:
            raise RuntimeError("no cluster environment: set COORDINATOR_ADDRESS, NUM_PROCESSES and "
                               "PROCESS_ID, or launch with torchrun")
        return False
    init_method, world, rank = found
    backend = backend_for(device)
    try:
        if backend == "nccl":
            torch.cuda.set_device(local_rank())
        dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    except Exception:  # noqa: BLE001 - any failure of the bring-up means a single process
        if require:
            raise
        log.warning("process group initialisation failed; running as a single process", exc_info=True)
        return False
    log.info("process group: rank %d of %d, backend %s", dist.get_rank(), dist.get_world_size(),
             dist.get_backend())
    return dist.get_world_size() > 1


def check_mesh(cfg: Optional[MeshConfig], world: int) -> Tuple[int, int]:
    """(data, spatial) for a world of `world` processes, by the JAX
    package's `make_mesh` rules: `data = 0` means the whole world, and a
    `data * spatial` other than the world raises `ValueError`.  A mesh of
    several cards in a world of one process raises `NotImplementedError`: a
    JAX process drives all its host's devices, a rank of the port drives
    one card."""
    cfg = cfg or MeshConfig()
    spatial = max(cfg.spatial, 1)
    data = cfg.data if cfg.data > 0 else world // spatial
    if world == 1 and data * spatial > 1:
        raise NotImplementedError(
            f"mesh {data}x{spatial} (data x spatial) in a single process: the port runs one process "
            "a card; launch one rank a card (torchrun, or COORDINATOR_ADDRESS / NUM_PROCESSES / "
            "PROCESS_ID) and initialise the group (maybe_initialize_distributed)")
    if data * spatial != world:
        raise ValueError(f"mesh {data}x{spatial} (data x spatial) does not match the world of {world} "
                         "processes; pick data*spatial == world size")
    return data, spatial


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """This rank's place on the data x spatial grid and its two groups: the
    ranks that share its spatial tile index (`data_group`, None for data 1)
    and those that share its batch slice (`spatial_group`, None for
    spatial 1)."""

    data: int
    spatial: int
    data_index: int
    spatial_index: int
    data_group: Optional[dist.ProcessGroup]
    spatial_group: Optional[dist.ProcessGroup]


def make_mesh(cfg: Optional[MeshConfig] = None) -> RankMesh:
    """The mesh of `cfg` over the initialised world (a world of one without
    a group), laid out as the JAX package's `make_mesh` reshapes its
    devices to (data, spatial).  Every rank calls it: it makes every
    group."""
    world, rank = (dist.get_world_size(), dist.get_rank()) if dist.is_initialized() else (1, 0)
    data, spatial = check_mesh(cfg, world)
    grid = [list(range(d * spatial, (d + 1) * spatial)) for d in range(data)]
    data_group = spatial_group = None
    if spatial > 1:
        for ranks in grid:
            g = dist.new_group(ranks)
            spatial_group = g if rank in ranks else spatial_group
    if data > 1:
        for ranks in zip(*grid):
            g = dist.new_group(list(ranks))
            data_group = g if rank in ranks else data_group
    return RankMesh(data, spatial, rank // spatial, rank % spatial, data_group, spatial_group)


def rank_device(device=None) -> torch.device:
    """The card of this rank (`cuda:LOCAL_RANK`) where `device` names the
    card without an index, else `device` as `resolve_device` takes it."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank())
    return dev


def all_reduce_sum_(tensors: Sequence[torch.Tensor]) -> None:
    """Sum each tensor over the ranks, in place, in one collective (the
    tensors share a dtype and a device)."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    for t, v in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(v.view_as(t))


@torch.no_grad()
def broadcast_from_rank0_(module: torch.nn.Module) -> None:
    """Every parameter and buffer of `module` as rank 0 has it (one
    collective a dtype)."""
    by_dtype = {}
    for t in list(module.parameters()) + list(module.buffers()):
        by_dtype.setdefault(t.dtype, []).append(t.data)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.broadcast(flat, src=0)
        for t, v in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(v.view_as(t))
