"""Process-group start-up and the mesh over every rank.

The JAX package starts its runtime with ``jax.distributed.initialize`` and
meshes every chip of the slice; here ``initialize_distributed`` starts a
``torch.distributed`` process group (one rank a process, one device a rank)
and ``slice_mesh`` meshes every rank. Pixel rows shard over the ranks;
scene parameters are held whole on every rank, and the fit step's gradient
sum is the only collective that crosses hosts.

With no process group these helpers give the single process, so the same
script runs everywhere.
"""

from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist

from raytracer_tpu_torch.core.types import resolve_device
from raytracer_tpu_torch.parallel.mesh import TIMEOUT_S, Mesh, make_mesh

__all__ = ["initialize_distributed", "is_multi_host", "is_lead", "slice_mesh"]

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str | None = None,
    device=None,
) -> bool:
    """Start this process's ``torch.distributed`` process group.

    With explicit arguments, the group meets at ``tcp://coordinator_address``
    (``host:port``) with ``num_processes`` ranks, this one ``process_id``;
    the caller asked for several processes, so any failure raises. With none,
    torchrun's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``) is
    used through ``env://``; without it there is one process, and this
    returns ``False``. Returns ``True`` once the group is up (at once if it
    already was).

    ``device`` (default ``cuda:LOCAL_RANK``) becomes this rank's current
    CUDA device; ``backend`` defaults to NCCL on CUDA and gloo on the CPU.
    Every collective of the group waits at most ``mesh.TIMEOUT_S`` for its
    peers, then raises.
    """
    if dist.is_initialized():
        return True
    explicit = (coordinator_address, num_processes, process_id) != (None, None, None)
    if explicit:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("initialize_distributed needs coordinator_address, "
                             "num_processes and process_id together")
        if not 0 <= process_id < num_processes:
            raise ValueError(f"process_id {process_id} is not in [0, {num_processes})")
        init_method, world, rank = f"tcp://{coordinator_address}", num_processes, process_id
    elif all(k in os.environ for k in _TORCHRUN_ENV):
        init_method, world, rank = "env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        return False
    if device is None:
        local = int(os.environ.get("LOCAL_RANK", rank % max(torch.cuda.device_count(), 1)))
        device = f"cuda:{local}"
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"), init_method=init_method,
        world_size=world, rank=rank, timeout=timedelta(seconds=TIMEOUT_S),
    )
    return True


def is_multi_host() -> bool:
    """Whether ranks on more than one node take part: the world is larger
    than torchrun's ``LOCAL_WORLD_SIZE`` (the ranks of this node)."""
    if not dist.is_initialized():
        return False
    world = dist.get_world_size()
    return world > int(os.environ.get("LOCAL_WORLD_SIZE", world))


def is_lead() -> bool:
    """Whether this process writes files and prints: rank 0, or the only
    process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def slice_mesh(prim: int = 1, *, device=None) -> Mesh:
    """A ``(px, prim)`` mesh over every rank, host-major.

    torchrun numbers ranks node by node, so rank order is host-major: the
    ``px`` axis crosses nodes at its coarsest (pixel tiles never talk, so
    the links between nodes carry only the fit step's gradient sum), while a
    ``prim`` row, which combines hits every bounce, stays on one node.
    """
    return make_mesh(prim=prim, device=device)
