"""Ray generation and the bounce-loop dispatcher.

``trace_soa`` runs every bounce level of a ray tile in one call:
``trace_whole`` (the CUDA kernel) for CUDA tensors, ``trace_whole_reference``
(its plain PyTorch version) for CPU tensors. When gradients are wanted it
goes through ``_WholeTrace``, whose backward is ``trace_whole_bwd`` (the
backward kernel, or its plain version on the CPU). Every per-ray quantity is
a component plane in image layout ``[rows, W]`` (see core/v3.py).
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

        o, d = V3(ox, oy, oz), V3(dx, dy, dz)
        w = torch.ones_like(dx)
        rgb, t, i, res = cuda_fold.trace_whole(tables, o, d, w, depth, emit_res=True)
        ctx.tables, ctx.depth = tables, depth
        ctx.save_for_backward(attrs, ls, ox, oy, oz, dx, dy, dz, w, t, i, res)
        return tuple(rgb)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct_r, ct_g, ct_b):
        from raytracer_tpu_torch.ops import cuda_fold

        attrs, ls, ox, oy, oz, dx, dy, dz, w, t, i, res = ctx.saved_tensors
        levels = cuda_fold.Residuals(V3(ox, oy, oz), V3(dx, dy, dz), w, t, i, res)
        ct = V3(*(c.contiguous() for c in (ct_r, ct_g, ct_b)))
        ct_o, ct_d, _, ct_attrs, ct_ls = cuda_fold.trace_whole_bwd(
            ctx.tables, attrs, ls, levels, ct, ctx.depth
        )
        return None, None, ct_attrs, ct_ls, *ct_o, *ct_d


def trace_soa(scene: Scene, o: V3, d: V3, *, depth: int = 3) -> V3:
    """Radiance per ray (pre-tonemap) after ``depth`` mirror bounces.

    Each level adds ``w * (1 - metallic) * local`` on hits (the full
    ``local`` on the last level) or ``w * sky`` on misses, then reflects.
    All levels run in ``trace_whole``: its plain PyTorch version on CPU
    tensors (any scene, any depth), the CUDA kernel on CUDA tensors. The
    kernel covers scenes of at most ``FUSED_MAX_CHUNKS`` sphere chunks at
    ``0 <= depth <= FUSED_MAX_DEPTH``; outside that class a CUDA call
    raises. When grad is enabled and a scene leaf or a ray requires it, the
    trace runs through ``_WholeTrace`` and is differentiable in every scene
    leaf the shading reads and in the rays.
    """
    from raytracer_tpu_torch.ops import cuda_fold

    shape = torch.broadcast_shapes(*(c.shape for c in (*o, *d)))
    o, d = o.broadcast_to(shape), d.broadcast_to(shape)
    if d.x.device.type != "cpu":
        cuda_fold.check_fused_class(scene, depth)
    tables = cuda_fold.fused_tables(scene)
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (*scene.tensors(), *o, *d)
    ):
        attrs, ls = cuda_fold.attribute_tables(scene)
        return V3(*_WholeTrace.apply(tables, depth, attrs, ls, *o, *d))
    w = torch.ones(shape, dtype=torch.float32, device=d.x.device)
    acc, _, _ = cuda_fold.trace_whole(tables, o, d, w, depth)
    return acc


def render_tile(
    scene: Scene, camera: Camera, width: int, height: int, *,
    row_offset: int = 0, rows: int | None = None, depth: int = 3,
) -> V3:
    """Raygen + trace for a row tile; returns radiance V3 of ``[rows, W]``."""
    o, d = raygen_tile(camera, width, height, row_offset=row_offset, rows=rows)
    return trace_soa(scene, o, d, depth=depth)
