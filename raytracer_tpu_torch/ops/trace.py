"""Ray generation, the closest-hit API and the bounce-loop dispatcher.

``trace_soa`` runs every bounce level of a ray tile in one call. With the
default fold (``"auto"`` or ``"pallas"``) and no closest-hit function,
scenes of the whole-trace kernels' class (``cuda_fold.in_fused_class``: at
most 24 sphere chunks, depth at most 10, a table that fits 48 KB) go to
``trace_whole``, one CUDA kernel for all levels; every other scene (the
1024-sphere grid, deeper traces) goes to ``cuda_level.trace_levels``, the
per-level chain (a stats kernel, then one kernel per level). CPU tensors run
the kernels' plain PyTorch versions on the same routes. When gradients are
wanted the trace goes through ``_WholeTrace`` or ``_LevelTrace``, whose
backwards are the backward kernels (or their plain versions on the CPU).

Any other fold, or a closest-hit function, runs the bounce loop level by
level in PyTorch: each level's ``closest_hit_soa`` (the closest-hit kernels
of ops/cuda_hit.py: the record in one launch, ``_ShortlistHit``, or a fold
and ``hit_record``), then ``shade_soa``, ``background_soa``, the
accumulate and the bounce, with the shading formulas of the kernels' plain
versions (``cuda_fold._shade``, ``_sky``, ``_record_math``).
Every per-ray quantity is a component plane in image layout ``[rows, W]``
(see core/v3.py).
"""

from __future__ import annotations

import inspect
from typing import Callable, NamedTuple

import torch
from torch.autograd.function import once_differentiable

from raytracer_tpu_torch.core.types import Camera, Lights, Scene, Sky
from raytracer_tpu_torch.core.v3 import V3
from raytracer_tpu_torch.ops.raygen import camera_frame
from raytracer_tpu_torch.utils import profiler

__all__ = [
    "MISS_T",
    "REFLECT_EPS",
    "SoAHit",
    "raygen_tile",
    "fold_closest",
    "hit_record",
    "closest_hit_soa",
    "resolve_fold_fn",
    "shade_soa",
    "background_soa",
    "trace_soa",
    "render_tile",
]

MISS_T = 1e30  # large finite miss sentinel (never inf)
REFLECT_EPS = 1e-4  # secondary-ray origin offset along the normal


class SoAHit(NamedTuple):
    """Per-ray closest hit, every field a plane of the rays' shape: the
    winner's t, hit point, normal ((0, 0, 1) on a miss), global index (-1 on
    a miss) and its gathered material (zeros on a miss)."""

    t: torch.Tensor
    hit: torch.Tensor  # bool
    point: V3
    normal: V3
    prim_index: torch.Tensor  # int32
    color: V3
    ambient: torch.Tensor
    metallic: torch.Tensor
    diffuse: torch.Tensor
    specular: torch.Tensor
    specular_exponent: torch.Tensor

    @staticmethod
    def from_planes(planes) -> "SoAHit":
        """From the 16 planes of ``cuda_hit.record_planes``."""
        t, i, px, py, pz, nx, ny, nz, cr, cg, cb, amb, met, dif, spe, exq = planes
        return SoAHit(t=t, hit=i >= 0, point=V3(px, py, pz), normal=V3(nx, ny, nz),
                      prim_index=i, color=V3(cr, cg, cb), ambient=amb, metallic=met,
                      diffuse=dif, specular=spe, specular_exponent=exq)


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
    with profiler.span("rt.raygen"):
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


# ---------------------------------------------------------------------------
# The closest-hit API
# ---------------------------------------------------------------------------

# From this many primitives up, ``closest_hit_soa`` with a fold tagged
# ``_emits_hit_record`` (the shortlist fold) takes the whole hit record from
# one launch of the shortlist-hit kernel (``_ShortlistHit``); below it, the
# fold kernel and ``hit_record`` in PyTorch. The JAX package sets 32, where
# its one-hot-matmul gather began to pay. On the H100 the one launch is the
# faster call at every size swept (3, 65 and 1025 primitives at 1920x1080:
# about half the time of the fold and ``hit_record``; chip_smoke.py's
# ``cutoff_sweep``, PERF.md), so only a scene without primitives, where
# every ray misses, takes the fold.
_MM_GATHER_MIN_PRIMS = 1


def fold_closest(scene: Scene, o: V3, d: V3):
    """``(t, index)`` of every ray over every primitive: the plain fold
    (``fold="jnp"``), ``cuda_hit.fold_flat_reference`` in PyTorch on the
    rays' device whatever it is. Global indices: spheres, then walls, then
    boxes; ``(MISS_T, -1)`` on a miss."""
    from raytracer_tpu_torch.ops import cuda_fold, cuda_hit

    shape = torch.broadcast_shapes(*(c.shape for c in (*o, *d)))
    tables = cuda_fold.fused_tables(scene)
    return cuda_hit.fold_flat_reference(tables, o.broadcast_to(shape), d.broadcast_to(shape))


def hit_record(scene: Scene, o: V3, d: V3, best_t: torch.Tensor,
               best_i: torch.Tensor) -> SoAHit:
    """The closest hit at a fixed selection ``(best_t, best_i)``: the
    winner's attributes gathered by index and its t, point and normal
    recomputed (``cuda_hit.record_planes``). Differentiable in the scene's
    leaves (through ``attribute_tables``) and the rays; the selection is a
    constant."""
    from raytracer_tpu_torch.ops import cuda_fold, cuda_hit

    attrs, _ = cuda_fold.attribute_tables(scene)
    counts = {"n_s": len(scene.spheres), "n_w": len(scene.walls)}
    return SoAHit.from_planes(
        cuda_hit.record_planes(attrs.unbind(1), counts, o, d, best_t, best_i)
    )


class _ShortlistHit(torch.autograd.Function):
    """``cuda_hit.hit_closest_shortlist`` with ``hit_record``'s gradient.

    The counterpart of the JAX package's ``_pallas_hit``: the forward is
    the shortlist-hit kernel (the fold and the whole record in one launch),
    the backward differentiates ``record_planes`` with autograd at the
    kernel's selection (its t and index), as the JAX backward differentiates
    ``_mm_hit``. ``attrs`` (``attribute_tables`` of the scene) carries the
    cotangents back to the scene's leaves.
    """

    @staticmethod
    def forward(ctx, call, attrs, ox, oy, oz, dx, dy, dz):
        from raytracer_tpu_torch.ops import cuda_hit

        scene, active = call
        planes = cuda_hit.hit_closest_shortlist(scene, V3(ox, oy, oz), V3(dx, dy, dz),
                                                active=active)
        ctx.counts = {"n_s": len(scene.spheres), "n_w": len(scene.walls)}
        ctx.save_for_backward(attrs, ox, oy, oz, dx, dy, dz, planes[0], planes[1])
        ctx.mark_non_differentiable(planes[1])
        return planes

    @staticmethod
    @once_differentiable
    def backward(ctx, *cts):
        from raytracer_tpu_torch.ops import cuda_hit

        attrs, *rays, t, i = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [attrs.detach().requires_grad_(True)]
            leaves += [c.detach().requires_grad_(True) for c in rays]
            out = cuda_hit.record_planes(leaves[0].unbind(1), ctx.counts, V3(*leaves[1:4]),
                                         V3(*leaves[4:7]), t, i)
            grads = torch.autograd.grad((out[0], *out[2:]), leaves, (cts[0], *cts[2:]),
                                        allow_unused=True)
        return None, *(torch.zeros_like(x) if g is None else g for g, x in zip(grads, leaves))


def _needs_grad(scene: Scene, *planes) -> bool:
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in (*scene.tensors(), *planes)
    )


def closest_hit_soa(scene: Scene, o: V3, d: V3, *, fold_fn: Callable | None = None,
                    active: torch.Tensor | None = None) -> SoAHit:
    """Closest hit of each ray: a gradient-free fold, then the winner's
    record, differentiable in the scene's leaves and the rays.

    ``fold_fn(scene, o, d) -> (best_t, best_i)`` selects the winner; the
    default is ``cuda_hit.fold_closest_shortlist`` (the shortlist kernels
    on CUDA, their plain versions on the CPU). A fold tagged
    ``_emits_hit_record`` on a scene of at least ``_MM_GATHER_MIN_PRIMS``
    primitives gives the whole record in one launch (``_ShortlistHit``);
    otherwise the fold runs under ``no_grad`` and ``hit_record`` builds the
    record. ``active`` (optional bool, the rays' shape): lanes with zero
    path throughput, passed to a fold that takes it; the shortlist folds
    give them a miss record.
    """
    from raytracer_tpu_torch.ops import cuda_fold, cuda_hit

    if fold_fn is None:
        fold_fn = cuda_hit.fold_closest_shortlist
    if (getattr(fold_fn, "_emits_hit_record", False)
            and scene.num_primitives >= _MM_GATHER_MIN_PRIMS):
        if _needs_grad(scene, *o, *d):
            attrs, _ = cuda_fold.attribute_tables(scene)
            planes = _ShortlistHit.apply((scene, active), attrs, *o, *d)
        else:
            planes = cuda_hit.hit_closest_shortlist(scene, o, d, active=active)
        return SoAHit.from_planes(planes)
    with torch.no_grad():
        if active is not None and "active" in inspect.signature(fold_fn).parameters:
            best_t, best_i = fold_fn(scene, o, d, active=active)
        else:
            best_t, best_i = fold_fn(scene, o, d)
    return hit_record(scene, o, d, best_t, best_i)


def resolve_fold_fn(fold: str) -> Callable:
    """The fold of a selector, as ``closest_hit_soa`` takes it: ``"auto"``
    and ``"pallas"`` the shortlist fold (csrc/fold_shortlist.cu),
    ``"pallas_flat"`` the brute-force fold (csrc/fold_flat.cu), ``"jnp"``
    the plain fold (``fold_closest``). The names are the JAX package's."""
    from raytracer_tpu_torch.ops import cuda_hit

    if fold in ("auto", "pallas"):
        return cuda_hit.fold_closest_shortlist
    if fold == "pallas_flat":
        return cuda_hit.fold_closest_flat
    if fold == "jnp":
        return fold_closest
    raise ValueError(f"unknown fold backend: {fold!r}")


def shade_soa(rec: SoAHit, view: V3, lights: Lights) -> V3:
    """Local Blinn-Phong colour at each hit point (``cuda_fold._shade``:
    point lights, then suns made unit, the kernels' formulas); ``view`` is
    the direction towards the eye."""
    from raytracer_tpu_torch.ops import cuda_fold

    mats = (*rec.color, rec.ambient, rec.metallic, rec.diffuse, rec.specular,
            rec.specular_exponent)
    return cuda_fold._shade(
        mats, rec.point, rec.normal, view, cuda_fold._light_vector(cuda_fold._light_cols(lights)),
        lights.point_position.shape[0], lights.sun_color.shape[0],
    )


def background_soa(d: V3, sky: Sky) -> V3:
    """The sky along each direction: the ground colour below the horizon,
    the horizon-to-zenith power gradient above (``cuda_fold._sky``)."""
    from raytracer_tpu_torch.ops import cuda_fold

    return cuda_fold._sky(d.z, cuda_fold._sky_vector(sky))


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


def trace_soa(scene: Scene, o: V3, d: V3, *, depth: int = 3, fold: str = "auto",
              closest_hit_fn: Callable | None = None) -> V3:
    """Radiance per ray (pre-tonemap) after ``depth`` mirror bounces.

    Each level adds ``w * (1 - metallic) * local`` on hits (the full
    ``local`` on the last level) or ``w * sky`` on misses, then reflects.
    With ``fold`` ``"auto"`` or ``"pallas"`` and no ``closest_hit_fn``,
    scenes of the whole-trace class (``cuda_fold.in_fused_class``) run in
    ``trace_whole``, all others in the per-level chain
    ``cuda_level.trace_levels``; CUDA tensors launch the kernels, CPU
    tensors run their plain PyTorch versions. When grad is enabled and a
    scene leaf or a ray requires it, the trace runs through ``_WholeTrace``
    or ``_LevelTrace`` and is differentiable in every scene leaf the
    shading reads and in the rays.

    Any other ``fold`` (``resolve_fold_fn``), or a ``closest_hit_fn(scene,
    o, d[, active=]) -> SoAHit``, runs the bounce loop level by level in
    PyTorch around it (``_trace_per_level``), differentiable through
    autograd.
    """
    from raytracer_tpu_torch.ops import cuda_fold, cuda_level

    fold_fn = resolve_fold_fn(fold)
    if depth < 0:
        raise ValueError(f"depth {depth} is negative")
    shape = torch.broadcast_shapes(*(c.shape for c in (*o, *d)))
    o, d = o.broadcast_to(shape), d.broadcast_to(shape)
    if closest_hit_fn is None and fold not in ("auto", "pallas"):
        def closest_hit_fn(sc, oo, dd, active=None):
            return closest_hit_soa(sc, oo, dd, fold_fn=fold_fn, active=active)

    if closest_hit_fn is not None:
        return _trace_per_level(scene, o, d, depth, closest_hit_fn)
    with profiler.span("rt.pack"):
        tables = cuda_fold.fused_tables(scene)
    fused = cuda_fold.in_fused_class(tables, depth)
    if _needs_grad(scene, *o, *d):
        with profiler.span("rt.pack"):
            attrs, ls = cuda_fold.attribute_tables(scene)
        fn = _WholeTrace if fused else _LevelTrace
        with profiler.span("rt.trace"):
            return V3(*fn.apply(tables, depth, attrs, ls, *o, *d))
    with profiler.span("rt.trace"):
        w = torch.ones(shape, dtype=torch.float32, device=d.x.device)
        trace = cuda_fold.trace_whole if fused else cuda_level.trace_levels
        acc, _, _ = trace(tables, o, d, w, depth)
    return acc


def _trace_per_level(scene: Scene, o: V3, d: V3, depth: int, closest_hit_fn) -> V3:
    """The bounce loop one level at a time around ``closest_hit_fn``: the
    counterpart of the JAX ``trace_soa``'s loop. Level 0 passes no
    ``active``; later levels pass ``w > 0`` to a function that takes it, and
    an inactive lane adds nothing whatever record it gets."""
    try:
        takes_active = "active" in inspect.signature(closest_hit_fn).parameters
    except (TypeError, ValueError):
        takes_active = False
    w = torch.ones(d.x.shape, dtype=torch.float32, device=d.x.device)
    acc = V3(torch.zeros_like(w), torch.zeros_like(w), torch.zeros_like(w))
    active = None
    for k in range(depth + 1):
        if takes_active:
            rec = closest_hit_fn(scene, o, d, active=active)
        else:
            rec = closest_hit_fn(scene, o, d)
        local = shade_soa(rec, V3(-d.x, -d.y, -d.z), scene.lights)
        sky = background_soa(d, scene.sky)
        is_last = k == depth
        hit_color = local if is_last else local * (1.0 - rec.metallic)
        take = rec.hit if active is None else rec.hit & active
        acc = acc + V3.where(take, hit_color, sky) * w
        if not is_last:
            w = w * torch.where(rec.hit, rec.metallic, 0.0)
            o = V3.where(rec.hit, rec.point + rec.normal * REFLECT_EPS, o)
            dn2 = 2.0 * d.dot(rec.normal)
            d = V3.where(rec.hit, d - rec.normal * dn2, d)
            active = (w > 0.0).detach()
    return acc


def render_tile(
    scene: Scene, camera: Camera, width: int, height: int, *,
    row_offset: int = 0, rows: int | None = None, depth: int = 3, fold: str = "auto",
    closest_hit_fn: Callable | None = None,
) -> V3:
    """Raygen + trace for a row tile; returns radiance V3 of ``[rows, W]``."""
    o, d = raygen_tile(camera, width, height, row_offset=row_offset, rows=rows)
    return trace_soa(scene, o, d, depth=depth, fold=fold, closest_hit_fn=closest_hit_fn)
