"""The rank mesh and the scene's partition over it.

The mesh's two axes are ``('px', 'prim')``: pixel-row data parallelism and
optional primitive (sphere-axis) parallelism, as in the JAX package's
``parallel/mesh.py``. There a mesh is a grid of devices that ``shard_map``
programs run over; here it is a grid of ``torch.distributed`` ranks, one
process (and one device) each, with a process group for this rank's ``px``
column, its ``prim`` row and the whole mesh. ``prim=1`` is pure pixel
sharding, the counterpart of the reference renderer's scanline split over
threads.
"""

from __future__ import annotations

import dataclasses
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from raytracer_tpu_torch.core.types import (
    Boxes,
    Lights,
    Materials,
    Scene,
    Sky,
    Spheres,
    Walls,
    resolve_device,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "scene_pspecs",
    "shard_scene",
    "pad_scene_spheres",
    "PX_AXIS",
    "PRIM_AXIS",
    "TIMEOUT_S",
]

PX_AXIS = "px"
PRIM_AXIS = "prim"

# Seconds a collective (and a group's creation) waits for its peers before
# it raises, on the process group ``initialize_distributed`` starts and on
# every group of a mesh: a dead or stuck rank fails the others instead of
# hanging them.
TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A ``(px, prim)`` grid of ranks, as this rank sees it.

    ``devices`` is the grid of global ranks (``[px, prim]``); ``rank`` and
    ``coords`` are this process's global rank and its ``(px, prim)`` place
    (``None`` for a rank outside the mesh); ``px_group`` holds the ranks of
    this rank's ``px`` column (same ``prim`` index), ``prim_group`` those of
    its ``prim`` row (same ``px`` index), ``group`` the whole mesh. A mesh
    made without a process group (one rank) has no groups, and its
    collectives are identities, as on a 1x1 ``jax.sharding.Mesh``.
    """

    devices: np.ndarray
    rank: int | None
    coords: tuple[int, int] | None
    px_group: object
    prim_group: object
    group: object
    device: torch.device

    @property
    def shape(self) -> dict:
        px, prim = self.devices.shape
        return {PX_AXIS: int(px), PRIM_AXIS: int(prim)}

    @property
    def size(self) -> int:
        return int(self.devices.size)


def make_mesh(px: int | None = None, prim: int = 1, ranks=None, *, device=None) -> Mesh:
    """A ``(px, prim)`` mesh over ``ranks`` (default: every rank of the
    process group, or this process alone when there is none).

    With ``px=None`` the pixel axis takes every rank ``prim`` does not. The
    ranks are laid out row-major, ``prim`` fastest, in increasing order, so
    that a ``prim`` row is a run of neighbouring ranks (one host, under
    torchrun). Every rank of the process group must call this, in the same
    order as its other ``make_mesh`` calls: the groups are made collectively
    (``dist.new_group``), ranks outside the mesh included; their
    collectives wait at most ``TIMEOUT_S``. ``device`` (``None``: CUDA, the
    current device) is where this rank renders.
    """
    dev = resolve_device(device)
    up = dist.is_available() and dist.is_initialized()
    if ranks is None:
        ranks = range(dist.get_world_size()) if up else [0]
    ranks = [int(r) for r in ranks]
    n = len(ranks)
    if px is None:
        if n % prim:
            raise ValueError(f"{n} ranks not divisible by prim={prim}")
        px = n // prim
    if not up and (px, prim, ranks) != (1, 1, [0]):
        raise ValueError(
            f"mesh {px}x{prim} needs a process group of {px * prim} ranks: launch under "
            "torchrun, or call initialize_distributed first"
        )
    if px < 1 or prim < 1 or px * prim != n:
        raise ValueError(f"mesh {px}x{prim} != {n} ranks")
    if any(b <= a for a, b in zip(ranks, ranks[1:])):
        raise ValueError(f"mesh ranks must increase: {ranks}")
    grid = np.array(ranks, dtype=np.int64).reshape(px, prim)
    if not up:
        return Mesh(grid, 0, (0, 0), None, None, None, dev)
    me = dist.get_rank()
    timeout = timedelta(seconds=TIMEOUT_S)
    # Every rank makes every group, in this fixed order (a group that some
    # ranks never make leaves the others waiting).
    rows = [dist.new_group(grid[i].tolist(), timeout=timeout) for i in range(px)]
    cols = [dist.new_group(grid[:, j].tolist(), timeout=timeout) for j in range(prim)]
    whole = dist.new_group(ranks, timeout=timeout)
    if me not in ranks:
        return Mesh(grid, me, None, None, None, None, dev)
    i, j = (int(v[0]) for v in np.nonzero(grid == me))
    return Mesh(grid, me, (i, j), cols[j], rows[i], whole, dev)


def _mat_specs(spec) -> Materials:
    return Materials(*([spec] * 6))


def scene_pspecs() -> Scene:
    """The scene's partition, leaf for leaf: ``PRIM_AXIS`` for a leaf whose
    leading (sphere) axis is sliced over the ``prim`` axis, ``None`` for a
    leaf every rank holds whole. Spheres are sliced; walls, boxes, lights
    and the sky are held whole (walls are few; a wall hit that every shard
    finds combines to the same record through the lowest shard)."""
    rep = None
    return Scene(
        spheres=Spheres(center=PRIM_AXIS, radius=PRIM_AXIS, material=_mat_specs(PRIM_AXIS)),
        walls=Walls(position=rep, normal=rep, length=rep, width=rep, material=_mat_specs(rep)),
        boxes=Boxes(minimum=rep, maximum=rep, material=_mat_specs(rep)),
        lights=Lights(*([rep] * 4)),
        sky=Sky(*([rep] * 4)),
    )


def _map2(fn, a, b):
    """``fn(x, spec)`` over the leaves of ``a`` and the same leaves of ``b``."""
    if isinstance(a, (Scene, Spheres, Walls, Boxes, Lights, Sky, Materials)):
        return dataclasses.replace(a, **{
            f.name: _map2(fn, getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(a)
        })
    return fn(a, b)


def shard_scene(scene: Scene, shard: int, n_shards: int) -> Scene:
    """Shard ``shard`` of ``n_shards`` of a scene whose sphere count is a
    multiple of ``n_shards`` (``pad_scene_spheres``): the leaves that
    ``scene_pspecs`` marks ``PRIM_AXIS`` sliced to their ``shard``-th equal
    part, the others whole. Slices keep autograd."""
    n = len(scene.spheres) // n_shards

    def part(x, spec):
        return x[shard * n:(shard + 1) * n] if spec == PRIM_AXIS else x

    return _map2(part, scene, scene_pspecs())


def pad_scene_spheres(scene: Scene, multiple: int) -> Scene:
    """Pad the sphere axis to a multiple of ``multiple`` with never-hit spheres.

    Pad spheres sit at 1e8 with radius 0, so the discriminant is negative for
    every real ray; their materials are zeros. The pad is joined with
    ``torch.cat``, so the padded scene stays differentiable in the real
    spheres (the pads get no gradient), as the JAX package's ``concatenate``.
    """
    n = len(scene.spheres)
    pad = -n % multiple
    if pad == 0:
        return scene
    s = scene.spheres

    def pad_leaf(x, fill):
        return torch.cat([x, x.new_full((pad, *x.shape[1:]), fill)])

    return scene.replace(spheres=Spheres(
        center=pad_leaf(s.center, 1e8),
        radius=pad_leaf(s.radius, 0.0),
        material=dataclasses.replace(s.material, **{
            f.name: pad_leaf(getattr(s.material, f.name), 0.0)
            for f in dataclasses.fields(s.material)
        }),
    ))
