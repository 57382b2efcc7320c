"""Ray generation and the bounce-loop dispatcher.

``trace_soa`` runs every bounce level of a ray tile in one call. Scenes of
the whole-trace kernels' class (``cuda_fold.in_fused_class``: at most 24
sphere chunks, depth at most 10, a table that fits 48 KB) go to
``trace_whole``, one CUDA kernel for all levels; every other scene (the
1024-sphere grid, deeper traces) goes to ``cuda_level.trace_levels``, the
per-level chain (a stats kernel, then one kernel per level). CPU tensors run
the kernels' plain PyTorch versions on the same routes. When gradients are
wanted the trace goes through ``_WholeTrace`` or ``_LevelTrace``, whose
backwards are the backward kernels (or their plain versions on the CPU).
Every per-ray quantity is a component plane in image layout ``[rows, W]``
(see core/v3.py).
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from raytracer_tpu_torch.core.types import Camera, Scene
from raytracer_tpu_torch.core.v3 import V3
from raytracer_tpu_torch.ops.raygen import camera_frame

__all__ = ["MISS_T", "REFLECT_EPS", "raygen_tile", "trace_soa", "render_tile"]

MISS_T = 1e30  # large finite miss sentinel (never inf)
REFLECT_EPS = 1e-4  # secondary-ray origin offset along the normal


def raygen_tile(
    camera: Camera, width: int, height: int, row_offset: int = 0,
    rows: int | None = None,
) -> tuple[V3, V3]:
    """Primary rays for rows ``[row_offset, row_offset+rows)`` of the image.

    Returns ``(origin, direction)``: origin is a V3 of 0-d tensors (pinhole),
    direction a V3 of ``[rows, W]`` unit components. The direction is
    ``origin - pixel_center``, the reference renderer's flip, which the
    demo scene's layout depends on.
    """
    rows = height if rows is None else rows
    frame = camera_frame(camera, width, height)
    tl = V3.from_stacked(frame.image_top_left)
    dx = V3.from_stacked(frame.pixel_delta_x)
    dy = V3.from_stacked(frame.pixel_delta_y)
    origin = V3.from_stacked(frame.origin)
    dev = frame.origin.device
    jj = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    ii = torch.arange(rows, dtype=torch.float32, device=dev)[:, None] + row_offset
    pc = V3(
        tl.x + dx.x * jj + dy.x * ii,
        tl.y + dx.y * jj + dy.y * ii,
        tl.z + dx.z * jj + dy.z * ii,
    )
    return origin, (origin - pc).normalized()


def _wall_tables(walls) -> dict:
    """Per-wall scalars for the fold: the normal, the in-plane basis
    ``right = normalize(cross(n, z))``, ``up = normalize(cross(right, n))``
    (degenerate for normals parallel to z, as in the reference renderer),
    the corner, the plane offset and the extents."""
    n = V3.from_stacked(walls.normal)
    z = V3(torch.zeros_like(n.x), torch.zeros_like(n.x), torch.ones_like(n.x))
    right = n.cross(z).normalized()
    up = right.cross(n).normalized()
    p = V3.from_stacked(walls.position)
    return {
        "nx": n.x, "ny": n.y, "nz": n.z,
        "rx": right.x, "ry": right.y, "rz": right.z,
        "ux": up.x, "uy": up.y, "uz": up.z,
        "px": p.x, "py": p.y, "pz": p.z,
        "dplane": p.dot(n),
        "length": walls.length,
        "width": walls.width,
    }


def _trace_forward(ctx, fwd, tables, depth, attrs, ls, ox, oy, oz, dx, dy, dz):
    """The training forward of either route: ``fwd`` (``trace_whole`` or
    ``trace_levels``) with residuals, whose selections and per-level inputs
    are saved for the backward."""
    o, d = V3(ox, oy, oz), V3(dx, dy, dz)
    w = torch.ones_like(dx)
    rgb, t, i, res = fwd(tables, o, d, w, depth, emit_res=True)
    ctx.tables, ctx.depth = tables, depth
    ctx.save_for_backward(attrs, ls, ox, oy, oz, dx, dy, dz, w, t, i, res)
    return tuple(rgb)


def _trace_backward(ctx, bwd, ct_r, ct_g, ct_b):
    from raytracer_tpu_torch.ops import cuda_fold

    attrs, ls, ox, oy, oz, dx, dy, dz, w, t, i, res = ctx.saved_tensors
    levels = cuda_fold.Residuals(V3(ox, oy, oz), V3(dx, dy, dz), w, t, i, res)
    ct = V3(*(c.contiguous() for c in (ct_r, ct_g, ct_b)))
    ct_o, ct_d, _, ct_attrs, ct_ls = bwd(ctx.tables, attrs, ls, levels, ct, ctx.depth)
    return None, None, ct_attrs, ct_ls, *ct_o, *ct_d


class _WholeTrace(torch.autograd.Function):
    """``trace_whole`` with ``trace_whole_bwd`` as its backward.

    The counterpart of the JAX package's ``_pallas_trace`` custom VJP. Every
    fold is selection-only, so the gradient is that of each level's
    ``_level_math`` at the forward's selections. The forward runs the
    kernel with ``emit_res`` and saves the selections and each level's input
    rays and throughput; the backward runs the backward kernel on them. The
    kernels read the scene from the packed ``tables``; ``attrs`` and ``ls``
    (``attribute_tables`` of the same scene) carry the table cotangents
    back to the scene's leaves through autograd.
    """

    @staticmethod
    def forward(ctx, tables, depth, attrs, ls, ox, oy, oz, dx, dy, dz):
        from raytracer_tpu_torch.ops import cuda_fold

        return _trace_forward(ctx, cuda_fold.trace_whole, tables, depth, attrs, ls,
                              ox, oy, oz, dx, dy, dz)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct_r, ct_g, ct_b):
        from raytracer_tpu_torch.ops import cuda_fold

        return _trace_backward(ctx, cuda_fold.trace_whole_bwd, ct_r, ct_g, ct_b)


class _LevelTrace(torch.autograd.Function):
    """``cuda_level.trace_levels`` with ``trace_levels_bwd`` as its
    backward: ``_WholeTrace`` for the per-level route. The forward chain
    keeps each level's input rays and throughput (its own outputs) and
    selections; the backward launches the per-level backward kernel for
    k = depth..0."""

    @staticmethod
    def forward(ctx, tables, depth, attrs, ls, ox, oy, oz, dx, dy, dz):
        from raytracer_tpu_torch.ops import cuda_level

        return _trace_forward(ctx, cuda_level.trace_levels, tables, depth, attrs, ls,
                              ox, oy, oz, dx, dy, dz)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct_r, ct_g, ct_b):
        from raytracer_tpu_torch.ops import cuda_level

        return _trace_backward(ctx, cuda_level.trace_levels_bwd, ct_r, ct_g, ct_b)


def trace_soa(scene: Scene, o: V3, d: V3, *, depth: int = 3) -> V3:
    """Radiance per ray (pre-tonemap) after ``depth`` mirror bounces.

    Each level adds ``w * (1 - metallic) * local`` on hits (the full
    ``local`` on the last level) or ``w * sky`` on misses, then reflects.
    Scenes of the whole-trace class (``cuda_fold.in_fused_class``) run in
    ``trace_whole``, all others in the per-level chain
    ``cuda_level.trace_levels``; CUDA tensors launch the kernels, CPU
    tensors run their plain PyTorch versions. When grad is enabled and a
    scene leaf or a ray requires it, the trace runs through ``_WholeTrace``
    or ``_LevelTrace`` and is differentiable in every scene leaf the
    shading reads and in the rays.
    """
    from raytracer_tpu_torch.ops import cuda_fold, cuda_level

    if depth < 0:
        raise ValueError(f"depth {depth} is negative")
    shape = torch.broadcast_shapes(*(c.shape for c in (*o, *d)))
    o, d = o.broadcast_to(shape), d.broadcast_to(shape)
    tables = cuda_fold.fused_tables(scene)
    fused = cuda_fold.in_fused_class(tables, depth)
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (*scene.tensors(), *o, *d)
    ):
        attrs, ls = cuda_fold.attribute_tables(scene)
        fn = _WholeTrace if fused else _LevelTrace
        return V3(*fn.apply(tables, depth, attrs, ls, *o, *d))
    w = torch.ones(shape, dtype=torch.float32, device=d.x.device)
    trace = cuda_fold.trace_whole if fused else cuda_level.trace_levels
    acc, _, _ = trace(tables, o, d, w, depth)
    return acc


def render_tile(
    scene: Scene, camera: Camera, width: int, height: int, *,
    row_offset: int = 0, rows: int | None = None, depth: int = 3,
) -> V3:
    """Raygen + trace for a row tile; returns radiance V3 of ``[rows, W]``."""
    o, d = raygen_tile(camera, width, height, row_offset=row_offset, rows=rows)
    return trace_soa(scene, o, d, depth=depth)
