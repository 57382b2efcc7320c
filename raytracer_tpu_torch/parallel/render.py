"""Mesh-sharded rendering over ``torch.distributed`` ranks.

The counterpart of the JAX package's ``parallel/render.py``, the
replacement for the reference renderer's OpenMP scanline split: pixel rows
shard over the mesh's ``px`` axis (each rank generates and traces only its
own rows, and no ray crosses ranks), and the sphere axis optionally shards
over ``prim``: each ``prim`` rank folds its slice of the spheres, and the
per-shard closest hits combine every bounce by an all-gather of ``t`` and a
masked sum of the winner's record (``parallel/comm.py``). The scene is held
whole on every rank. Every rank traces a tile of the same shape with the
true frame height (pad rows past the bottom are traced, then cropped), and
the tiles are gathered once at the end, so each rank returns the whole
frame, as the JAX global array is.
"""

from __future__ import annotations

import warnings

import torch

from raytracer_tpu_torch.core.types import Camera, Scene
from raytracer_tpu_torch.core.v3 import V3
from raytracer_tpu_torch.ops.tonemap import reinhard_tonemap
from raytracer_tpu_torch.ops.trace import (
    SoAHit,
    closest_hit_soa,
    raygen_tile,
    resolve_fold_fn,
)
from raytracer_tpu_torch.parallel import comm
from raytracer_tpu_torch.parallel.mesh import (
    PRIM_AXIS,
    PX_AXIS,
    Mesh,
    pad_scene_spheres,
    shard_scene,
)
from raytracer_tpu_torch.render.integrator import _row_chunks, _trace_rows

__all__ = [
    "render_sharded",
    "render_sharded_impl",
    "render_soft_sharded_impl",
    "hard_tile",
    "soft_tile",
]


def _check_mesh(mesh) -> Mesh:
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh (make_mesh), not {type(mesh).__name__}")
    if mesh.coords is None:
        raise ValueError(f"rank {mesh.rank} is not in the mesh {mesh.devices.tolist()}")
    return mesh


def _globalize_prim_index(rec: SoAHit, n_s_local: int, n_s_global: int, shard: int) -> SoAHit:
    """Rewrite shard-local primitive indices as global scene indices.

    Local layout per shard: spheres ``[0, n_s_local)``, then walls and
    boxes; global layout: spheres ``[0, n_s_global)``, then walls and boxes,
    the unsharded ``closest_hit_soa`` numbering when ``n_s_global`` is the
    scene's sphere count before padding (pad spheres are never hit); -1
    stays a miss."""
    i = rec.prim_index
    gidx = torch.where(
        (i >= 0) & (i < n_s_local),
        i + shard * n_s_local,
        torch.where(i >= 0, i - n_s_local + n_s_global, -1),
    ).to(i.dtype)
    return rec._replace(prim_index=gidx)


def _planes(rec: SoAHit) -> list:
    """The record's 17 planes, its vectors by component, in field order."""
    return [p for f in rec for p in (f if isinstance(f, V3) else (f,))]


def _combine_hits(rec: SoAHit, group) -> SoAHit:
    """Reduce per-shard closest hits to the global closest hit.

    Only ``t`` crosses shards twice: an all-gather of ``t`` picks each ray's
    winner shard (least ``t``, the lowest shard on ties), then a masked sum
    gives every shard the winner's record (every other shard adds zeros):
    an all-reduce of one record instead of an all-gather of one record a
    shard. Ties between shards are walls and boxes, which every shard
    holds: the lowest shard's record is the same one."""
    mask = comm.winner_mask(rec.t, group)
    it = iter(comm.masked_sum(_planes(rec), mask, group))
    return SoAHit(*(V3(next(it), next(it), next(it)) if isinstance(f, V3) else next(it)
                    for f in rec))


def _prim_hit_fn(mesh: Mesh, fold: str, n_s_local: int, n_s_global: int):
    """The per-level closest hit of a ``prim`` shard: its spheres through
    the full closest-hit engine (``closest_hit_soa`` with the fold of
    ``fold``; the shortlist record kernel for the default), the index made
    global, the shards' hits combined."""
    fold_fn = resolve_fold_fn(fold)
    shard = mesh.coords[1]

    def hit_fn(sc, o, d, active=None):
        rec = closest_hit_soa(sc, o, d, fold_fn=fold_fn, active=active)
        rec = _globalize_prim_index(rec, n_s_local, n_s_global, shard)
        return _combine_hits(rec, mesh.prim_group)

    return hit_fn


def hard_tile(scene: Scene, camera: Camera, width: int, height: int, *, mesh: Mesh,
              depth: int = 3, tonemap: bool = True, fold: str = "auto"):
    """This rank's rows of the hard render: ``(tile, row0)``, ``tile`` the
    ``[rows, W, 3]`` image of rows ``[row0, row0 + rows)``, ``rows =
    ceil(H / px)``, the same on every ``prim`` rank of the ``px`` index.

    With ``prim = 1`` the tile is ``render``'s row tiling of these rows
    (``trace_soa``: the whole-trace kernel or the per-level chain), no
    collective. With ``prim > 1`` the spheres are padded to a multiple of
    ``prim`` (``pad_scene_spheres``) and this rank's slice traced by the
    per-level loop around ``closest_hit_soa``, the hits combined each level.
    """
    mesh = _check_mesh(mesh)
    n_px, n_prim = mesh.shape[PX_AXIS], mesh.shape[PRIM_AXIS]
    scene, camera = scene.to(mesh.device), camera.to(mesh.device)
    hit_fn = None
    if n_prim > 1:
        # The cost, as the JAX package states it: the per-bounce combine
        # moves O(rays) bytes across the 'prim' axis a level (pure px
        # sharding moves none), and every prim rank still folds every ray.
        warnings.warn(
            f"prim={n_prim} sharding: the per-bounce hit combine all-gathers/sums "
            "O(rays) values a level; prefer px-only sharding unless the sphere "
            "tables outgrow one device",
            stacklevel=3,
        )
        n_s_global = len(scene.spheres)
        scene = pad_scene_spheres(scene, n_prim)
        n_s_local = len(scene.spheres) // n_prim
        scene = shard_scene(scene, mesh.coords[1], n_prim)
        hit_fn = _prim_hit_fn(mesh, fold, n_s_local, n_s_global)
    rows = -(-height // n_px)
    row0 = mesh.coords[0] * rows
    img = _trace_rows(scene, camera, width, height, row0, rows, _row_chunks(width, rows, 0),
                      depth=depth, fold=fold, closest_hit_fn=hit_fn)
    return (reinhard_tonemap(img) if tonemap else img), row0


def render_sharded(scene: Scene, camera: Camera, width: int, height: int, *, mesh: Mesh,
                   depth: int = 3, tonemap: bool = True, fold: str = "auto") -> torch.Tensor:
    """Mesh-sharded render to an ``[H, W, 3]`` image on every rank:
    ``hard_tile`` on each rank, the tiles gathered over the ``px`` column
    and the pad rows cropped. Runs on ``mesh.device``; every rank of the
    mesh must call it.

    Equal to the single-rank ``render`` (same frustum, same integrator) bit
    for bit on the ``px`` axis; on the ``prim`` axis equal to the
    single-rank per-level loop around ``closest_hit_soa``. Differentiable: a
    loss taken alike on every rank, its gradients summed over the mesh
    (``comm.sum_grads``), gets the single-rank gradient (the gather's
    backward keeps this rank's rows; over ``prim`` the combine's backward
    sums them, hence the ``1 / prim``)."""
    tile, _ = hard_tile(scene, camera, width, height, mesh=mesh, depth=depth,
                        tonemap=tonemap, fold=fold)
    img = comm.gather_rows(tile, mesh.px_group, 1.0 / mesh.shape[PRIM_AXIS])
    return img[:height] if img.shape[0] != height else img


# The JAX package's un-jitted name for the same function.
render_sharded_impl = render_sharded


def soft_tile(scene: Scene, camera: Camera, width: int, height: int, *, mesh: Mesh,
              tau=0.02, tau_z=0.05, tonemap: bool = True, depth: int = 0):
    """This rank's rows of the soft render: ``(tile, row0)``. The ``(px,
    prim)`` axes fold into one row axis over every rank (rank ``px *
    prim_count + prim`` takes the rows ``ceil(H / ranks)`` times its place):
    the soft compositor streams every primitive for every ray, so ``prim``
    has no primitive-parallel meaning here, and the spheres are not padded."""
    from raytracer_tpu_torch.diff.soft import trace_soft

    mesh = _check_mesh(mesh)
    scene, camera = scene.to(mesh.device), camera.to(mesh.device)
    rows = -(-height // mesh.size)
    row0 = (mesh.coords[0] * mesh.shape[PRIM_AXIS] + mesh.coords[1]) * rows
    o, d = raygen_tile(camera, width, height, row_offset=row0, rows=rows)
    img = trace_soft(scene, o, d, tau=tau, tau_z=tau_z, depth=depth).stacked()
    return (reinhard_tonemap(img) if tonemap else img), row0


def render_soft_sharded_impl(scene: Scene, camera: Camera, width: int, height: int, *,
                             mesh: Mesh, tau=0.02, tau_z=0.05, tonemap: bool = True,
                             depth: int = 0) -> torch.Tensor:
    """Mesh-sharded soft-visibility render to ``[H, W, 3]`` on every rank:
    ``soft_tile`` on each rank, gathered over the whole mesh, cropped.
    Differentiable as ``render_sharded``."""
    tile, _ = soft_tile(scene, camera, width, height, mesh=mesh, tau=tau, tau_z=tau_z,
                        tonemap=tonemap, depth=depth)
    img = comm.gather_rows(tile, mesh.group)
    return img[:height] if img.shape[0] != height else img
