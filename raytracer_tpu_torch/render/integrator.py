"""The public render pipeline: ray generation, the bounce loop, tone map.

The compute lives in ops/trace.py in component-SoA image layout; this module
handles the API boundary (``[H, W, 3]`` images, ``[P, 3]`` ray batches), row
chunking for very large frames, supersampling, and the depth-only pass.
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.core.types import Camera, Scene, resolve_device
from raytracer_tpu_torch.core.v3 import V3
from raytracer_tpu_torch.ops.tonemap import reinhard_tonemap
from raytracer_tpu_torch.ops.trace import closest_hit_soa, raygen_tile, render_tile, trace_soa
from raytracer_tpu_torch.utils import profiler

__all__ = ["trace_rays", "render", "render_depth"]

# Pixels per row chunk: bounds the live [rows, W] planes of 4K+ frames.
_CHUNK_PIXELS = 1 << 21


def _row_chunks(width: int, height: int, row_chunk: int) -> int:
    """Rows per chunk (the whole image when it is small enough)."""
    if row_chunk:
        return row_chunk
    if width * height <= _CHUNK_PIXELS:
        return height
    return max(1, _CHUNK_PIXELS // width)


def _trace_rows(scene: Scene, camera: Camera, width: int, height: int, row0: int, rows: int,
                chunk: int, *, depth: int, fold: str, closest_hit_fn=None) -> torch.Tensor:
    """Radiance of rows ``[row0, row0 + rows)`` of the ``width`` x
    ``height`` frame, ``[rows, W, 3]``: ``render_tile`` on chunks of
    ``chunk`` rows, joined (``render``'s tiling, and a mesh rank's)."""
    tiles = [
        render_tile(
            scene, camera, width, height, row_offset=row0 + r0, rows=min(chunk, rows - r0),
            depth=depth, fold=fold, closest_hit_fn=closest_hit_fn,
        ).stacked()
        for r0 in range(0, rows, chunk)
    ]
    return tiles[0] if len(tiles) == 1 else torch.cat(tiles, dim=0)


def trace_rays(
    scene: Scene,
    origins: torch.Tensor,  # f32[P, 3]
    directions: torch.Tensor,  # f32[P, 3] unit
    *,
    depth: int = 3,
    device=None,
) -> torch.Tensor:
    """Radiance transported along each ray, ``[P, 3]`` (pre-tonemap)."""
    dev = resolve_device(device)
    scene = scene.to(dev)
    o = V3.from_stacked(origins.to(dev, torch.float32)[None])
    d = V3.from_stacked(directions.to(dev, torch.float32)[None])
    return trace_soa(scene, o, d, depth=depth).stacked()[0]


def render(
    scene: Scene,
    camera: Camera,
    width: int,
    height: int,
    *,
    depth: int = 3,
    tonemap: bool = True,
    row_chunk: int = 0,
    fold: str = "auto",
    supersample: int = 1,
    device=None,
) -> torch.Tensor:
    """Render the scene to an ``[H, W, 3]`` float image in [0, 1).

    Raygen, the bounce loop and the Reinhard tone map. ``row_chunk=0``
    picks a row tiling that bounds memory on large frames. ``fold`` selects
    the closest-hit fold (``ops/trace.py:resolve_fold_fn``): ``"auto"`` and
    ``"pallas"`` trace in the whole-trace or per-level kernels,
    ``"pallas_flat"`` and ``"jnp"`` run the bounce loop level by level
    around the brute-force fold kernel or the plain fold. ``supersample=k``
    traces k*k rays per pixel on a finer grid and box-filters the radiance
    before the tone map. ``device=None`` renders on CUDA. A frame is a
    request of the span registry (``rt.render``, ``utils/profiler.py``).
    """
    with profiler.request("rt.render"):
        dev = resolve_device(device)
        scene, camera = scene.to(dev), camera.to(dev)
        ss = supersample
        rw, rh = width * ss, height * ss
        rows = _row_chunks(rw, rh, row_chunk * ss if row_chunk else 0)
        rows -= rows % ss  # keep chunk boundaries on whole-pixel rows
        rows = max(rows, ss)
        img = _trace_rows(scene, camera, rw, rh, 0, rh, rows, depth=depth, fold=fold)
        if ss > 1:
            img = img.reshape(height, ss, width, ss, 3).mean(dim=(1, 3))
        return reinhard_tonemap(img) if tonemap else img


def render_depth(
    scene: Scene,
    camera: Camera,
    width: int,
    height: int,
    *,
    row_chunk: int = 0,
    device=None,
) -> torch.Tensor:
    """Depth-only pass: the closest hit's distance per pixel, ``[H, W]``,
    +inf where the primary ray misses.

    ``closest_hit_soa`` on each row chunk's camera rays (the shortlist-hit
    kernel, or the shortlist fold and ``hit_record`` on scenes of few
    primitives); the distance is the hit record's t, recomputed for the
    winner. ``row_chunk=0`` picks the row tiling ``render`` uses.
    ``device=None`` runs on CUDA.
    """
    dev = resolve_device(device)
    scene, camera = scene.to(dev), camera.to(dev)
    rows = _row_chunks(width, height, row_chunk)
    tiles = []
    for r0 in range(0, height, rows):
        o, d = raygen_tile(camera, width, height, row_offset=r0, rows=min(rows, height - r0))
        rec = closest_hit_soa(scene, o, d)
        tiles.append(torch.where(rec.hit, rec.t, torch.inf))
    return tiles[0] if len(tiles) == 1 else torch.cat(tiles, dim=0)
