"""The row mesh and the process group (counterpart of
:mod:`cuda_mat_tpu.parallel.mesh`, cuda_mat_tpu/parallel/mesh.py:18-55).

The JAX package's mesh is a 1-D array of devices, one row shard each.  Here
a shard is a slice of rows, not a device: a process keeps a contiguous run
of the mesh's shards on its one torch device, as one ``(S, shard_rows)``
tensor per vector.  One process may hold every shard (``make_mesh(8)`` is 8
shards on ``cuda:0``, the counterpart of the JAX tests' 8 virtual CPU
devices); across processes, ``torch.distributed`` carries what the JAX
``shard_map`` does between devices (:mod:`.collectives`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist

ROWS_AXIS = "rows"


def _backend_for(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     device="cuda") -> None:
    """Join the process group (the JAX ``jax.distributed.initialize``,
    mesh.py:21-36).  With no coordinator and no process count it does
    nothing, as in JAX (:31-33).  Otherwise ``coordinator_address`` is
    ``host:port`` (or ``tcp://host:port``) of rank 0, and every process
    passes the same ``num_processes`` and its own ``process_id``.

    ``device`` is the kind of device the process's mesh will use: NCCL
    carries CUDA tensors, gloo CPU ones; :func:`make_mesh` refuses a mesh
    whose device does not match the group's backend."""
    if coordinator_address is None and num_processes is None:
        return
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("init_distributed needs coordinator_address,"
                         " num_processes and process_id together")
    addr = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    backend = _backend_for(device)
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=addr,
                            world_size=num_processes, rank=process_id)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``ndev`` row shards over ``world_size`` processes; this process
    (``rank``) holds shards ``[first, first + local)`` on ``device``."""

    ndev: int
    device: torch.device
    axis: str = ROWS_AXIS
    rank: int = 0
    world_size: int = 1

    @property
    def local(self) -> int:
        """S, the shards this process holds."""
        return self.ndev // self.world_size

    @property
    def first(self) -> int:
        return self.rank * self.local


def _default_device():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to make_mesh"
                           " to run the shards on the CPU")
    idx = dist.get_rank() % torch.cuda.device_count() \
        if dist.is_initialized() else 0
    return torch.device("cuda", idx)


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None,
              axis: str = ROWS_AXIS, *, device=None) -> Mesh:
    """A 1-D mesh of ``n_devices`` row shards (mesh.py:39-55).

    With no ``n_devices`` the mesh has one shard a process (JAX: every
    device).  ``devices``, where given, names this process's device once a
    shard (all the same device); ``n_devices`` then takes the first of them.
    ``device`` is where this process keeps its shards: by default the card
    of its local rank; a CPU mesh must be asked for (``device="cpu"``), and
    with no card and no ``device`` this raises.  Across processes
    (:func:`init_distributed`) the shards are split evenly, in rank order.
    """
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        if n_devices is not None:
            if n_devices > len(devices):
                raise ValueError(f"requested {n_devices} devices, only"
                                 f" {len(devices)} available")
            devices = devices[:n_devices]
        if len(set(devices)) != 1:
            raise ValueError("a process keeps all its shards on one device,"
                             f" got {sorted(map(str, set(devices)))}")
        if device is not None and torch.device(device) != devices[0]:
            raise ValueError(f"devices name {devices[0]}, device {device}")
        n_devices, device = len(devices), devices[0]
    world, rank = (dist.get_world_size(), dist.get_rank()) \
        if dist.is_initialized() else (1, 0)
    if n_devices is None:
        n_devices = world
    if n_devices < 1 or n_devices % world:
        raise ValueError(f"{n_devices} shards do not split evenly over"
                         f" {world} processes")
    device = _default_device() if device is None else torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"no CUDA device for a mesh on {device}")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    if world > 1 and dist.get_backend() != _backend_for(device):
        raise ValueError(f"the process group runs {dist.get_backend()}, which"
                         f" does not carry {device.type} tensors; call"
                         f" init_distributed(device={device.type!r})")
    return Mesh(n_devices, device, axis, rank, world)
