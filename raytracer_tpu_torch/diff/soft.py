"""Soft (relaxed) visibility rendering for gradient-based geometry fitting.

The hard renderer's closest-hit selection has no gradient at silhouettes: a
sphere's edge does not move under autograd, so fitting sphere centres to an
image stalls. This module relaxes the intersection and occlusion pipeline
with two temperatures, as the JAX package's ``diff/soft.py`` does:

* **coverage** ``alpha_i``: each primitive's hit test becomes a sigmoid in
  its decision quantity (the sphere discriminant, the wall's rectangle
  bounds, the box's slab overlap) times a behind-the-origin cut;
* **occlusion**: the closest hit becomes a softmax over relative depth
  ``-(t_i - t_ref)+ / tau_z``, anchored at ``t_ref``, each ray's front depth
  of the primitives with coverage above 0.3, found in a first pass without
  gradient;
* **background**: the primitives composite over the sky with the union
  coverage ``1 - prod(1 - alpha_i)``;
* **shading**: Blinn-Phong at each primitive's own soft hit point, blended
  by the softmax weights;
* **reflections** (``depth > 0``): one expected reflection ray per pixel
  about the surface the same weights blend from the primitives' hit points,
  normals and metallic.

As ``tau -> 0`` the weights become one-hot and the render converges to the
hard one. The per-primitive formulas here are plain tensor functions,
differentiable by autograd; ops/cuda_soft.py runs them level by level (its
plain versions) and its CUDA kernels (csrc/soft_level.cu,
csrc/soft_level_bwd.cu) compute the same per lane. The JAX package's XLA
path (a ``lax.scan`` over sphere chunks under ``checkpoint``, recursing on
the reflection) is not ported: the per-level form the kernels compute is
algebraically equal to it and differs by float32 reassociation.
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.core.types import Camera, Scene, resolve_device
from raytracer_tpu_torch.core.v3 import V3
from raytracer_tpu_torch.ops.cuda_fold import _srecip, max_c
from raytracer_tpu_torch.ops.tonemap import reinhard_tonemap
from raytracer_tpu_torch.ops.trace import raygen_tile
from raytracer_tpu_torch.utils import profiler

__all__ = ["trace_soft", "trace_soft_reference", "render_soft"]

FAR = 1e4  # reference depth of a ray that anchors on nothing
ALPHA_REF = 0.3  # coverage a primitive needs to anchor the reference depth


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + exp(-x))``: exactly 0 in float32 below about -89, in value
    and in its derivative ``y (1 - y)``, which the chunk gates rely on."""
    return torch.sigmoid(x)


def _normalized(v: V3, eps: float) -> V3:
    """``v / |v|`` with ``|v|^2`` clamped to ``eps`` (``max_c``, the JAX
    package's ``normalized(eps=...)``)."""
    return v * torch.rsqrt(max_c(v.norm2(), eps))


def _light_terms(ldir: V3, normal: V3, view: V3, exponent):
    """(diffuse, specular^e) for one unit light direction, the JAX package's
    ``ops/trace.py:_light_terms``: the half vector is scaled before its dot
    with the normal, its normalisation guarded where view + light is 0."""
    diffuse = max_c(ldir.dot(normal), 0.0)
    hv = view + ldir
    n2 = hv.norm2()
    half = hv * torch.rsqrt(torch.where(n2 > 1e-12, n2, 1.0))
    base = max_c(half.dot(normal), 0.0)
    pos = base > 0.0
    specular = torch.where(
        pos, torch.exp(exponent * torch.log(torch.where(pos, base, 1.0))), 0.0
    )
    return diffuse, specular


def _shade_point_scalar(point: V3, normal: V3, view: V3, color: V3, amb, kd, ks,
                        exp, pt_lights, sun_lights) -> V3:
    """Blinn-Phong at one primitive's soft hit point. ``pt_lights`` and
    ``sun_lights`` are tuples of per-light 6-tuples (position, or unit
    direction, xyz and colour rgb), as ops/cuda_soft.py's tables hold them."""
    ir = ig = ib = torch.zeros_like(point.x)
    for (lpx, lpy, lpz, lcr, lcg, lcb) in pt_lights:
        ldir = _normalized(V3(lpx - point.x, lpy - point.y, lpz - point.z), 1e-12)
        diff, spec = _light_terms(ldir, normal, view, exp)
        term = diff * kd + spec * ks
        ir, ig, ib = ir + lcr * term, ig + lcg * term, ib + lcb * term
    for (sdx, sdy, sdz, scr, scg, scb) in sun_lights:
        ones = torch.ones_like(point.x)
        diff, spec = _light_terms(V3(sdx * ones, sdy * ones, sdz * ones), normal, view, exp)
        term = diff * kd + spec * ks
        ir, ig, ib = ir + scr * term, ig + scg * term, ib + scb * term
    return V3(color.x * (ir + amb), color.y * (ig + amb), color.z * (ib + amb))


def _sphere_alpha_t_scalar(p: dict, o: V3, d: V3, tau):
    """(coverage, soft hit distance, hit point, unit normal) of one sphere
    (``p``: cx cy cz r). Past the silhouette the distance continues as
    ``-b``; the double ``where`` keeps sqrt's argument off 0 there, so no
    0 * inf reaches the gradient."""
    c = V3(p["cx"], p["cy"], p["cz"])
    r = p["r"]
    oc = o - c
    b_half = d.dot(oc)
    cc = oc.norm2() - r * r
    disc = b_half * b_half - cc  # > 0 inside the silhouette
    pos = disc > 0.0
    sq = torch.sqrt(torch.where(pos, disc, 1.0))
    t = -b_half - torch.where(pos, sq, 0.0)
    # Edge softness in world units: |d(disc)/d(distance)| at the rim ~ 2r.
    alpha = _sigmoid(disc / (tau * 2.0 * max_c(r, 1e-6)))
    alpha = alpha * _sigmoid(t / max_c(tau, 1e-6))  # behind-the-origin cut
    point = o + d * t
    # Normalised, not divided by r: continuation points lie far off the
    # sphere, and a long pseudo-normal would overflow the shading's pow.
    n = _normalized(point - c, 1e-12)
    return alpha, t, point, n


def _wall_alpha_t_scalar(p: dict, o: V3, d: V3, tau):
    """(coverage, hit distance, hit point, normal) of one wall (``p``: one
    ``_wall_tables`` row, nx ny nz dplane rx ry rz ux uy uz px py pz length
    width)."""
    denom = d.x * p["nx"] + d.y * p["ny"] + d.z * p["nz"]
    ok = torch.abs(denom) > 1e-6
    t = (p["dplane"] - (o.x * p["nx"] + o.y * p["ny"] + o.z * p["nz"])) / torch.where(
        ok, denom, 1.0
    )
    point = o + d * t
    relx = point.x - p["px"]
    rely = point.y - p["py"]
    relz = point.z - p["pz"]
    u = relx * p["rx"] + rely * p["ry"] + relz * p["rz"]
    v = relx * p["ux"] + rely * p["uy"] + relz * p["uz"]
    alpha = (
        _sigmoid(u / tau)
        * _sigmoid((p["length"] - u) / tau)
        * _sigmoid(v / tau)
        * _sigmoid((p["width"] - v) / tau)
        * _sigmoid(t / max_c(tau, 1e-6))
        * ok.to(t.dtype)
    )
    n = V3(*(torch.broadcast_to(p[k], t.shape) for k in ("nx", "ny", "nz")))
    return alpha, t, point, n


def _box_alpha_t_scalar(p: dict, o: V3, d: V3, tau):
    """(coverage, entry distance, hit point, entry-face normal) of one box
    (``p``: mnx mny mnz mxx mxy mxz). Coverage is a sigmoid in the slab
    overlap ``t_far - t_near`` times a front cut; the face normal carries no
    gradient."""
    inv = V3(_srecip(d.x), _srecip(d.y), _srecip(d.z))
    t1x, t2x = (p["mnx"] - o.x) * inv.x, (p["mxx"] - o.x) * inv.x
    t1y, t2y = (p["mny"] - o.y) * inv.y, (p["mxy"] - o.y) * inv.y
    t1z, t2z = (p["mnz"] - o.z) * inv.z, (p["mxz"] - o.z) * inv.z
    tn = torch.maximum(
        torch.maximum(torch.minimum(t1x, t2x), torch.minimum(t1y, t2y)),
        torch.minimum(t1z, t2z),
    )
    tf = torch.minimum(
        torch.minimum(torch.maximum(t1x, t2x), torch.maximum(t1y, t2y)),
        torch.maximum(t1z, t2z),
    )
    alpha = _sigmoid((tf - tn) / max_c(tau, 1e-6))
    alpha = alpha * _sigmoid(tn / max_c(tau, 1e-6))
    point = o + d * tn
    tx = (torch.where(d.x >= 0, p["mnx"], p["mxx"]) - o.x) * inv.x
    ty = (torch.where(d.y >= 0, p["mny"], p["mxy"]) - o.y) * inv.y
    tz = (torch.where(d.z >= 0, p["mnz"], p["mxz"]) - o.z) * inv.z
    is_x = (tx >= ty) & (tx >= tz)
    is_y = ~is_x & (ty >= tz)
    is_z = ~is_x & ~is_y
    n = V3(
        torch.where(is_x, -torch.sign(d.x), 0.0),
        torch.where(is_y, -torch.sign(d.y), 0.0),
        torch.where(is_z, -torch.sign(d.z), 0.0),
    )
    return alpha, tn, point, n


def _planes(o: V3, d: V3):
    """The rays as six contiguous planes of their broadcast shape: the
    kernels take any shape, one lane per element. Broadcasting by autograd
    is the counterpart of the JAX package's ``_unbroadcast``: the cotangent
    of a broadcast origin is summed back to its shape."""
    shape = torch.broadcast_shapes(*(c.shape for c in (*o, *d)))
    return o.broadcast_to(shape), d.broadcast_to(shape)


def trace_soft(scene: Scene, o: V3, d: V3, *, tau=0.02, tau_z=0.05, depth: int = 0) -> V3:
    """Softly composited radiance per ray (before the tone map), after
    ``depth`` expected-surface reflections.

    One soft level per reflection level (ops/cuda_soft.py ``soft_levels``):
    CUDA tensors launch csrc/soft_level.cu, CPU tensors run its plain
    version. When grad is enabled and a scene leaf, a ray or a temperature
    requires it, the trace runs through ``_SoftTrace``, whose backward is
    csrc/soft_level_bwd.cu (or its plain version). ``tau`` and ``tau_z``
    are floats or 0-d tensors; they are read by the kernels at run time,
    so a fit may anneal them without a rebuild.
    """
    from raytracer_tpu_torch.ops import cuda_soft

    if depth < 0:
        raise ValueError(f"depth {depth} is negative")
    o, d = _planes(o, d)
    dev = d.x.device
    tau, tau_z = (torch.as_tensor(x, dtype=torch.float32, device=dev) for x in (tau, tau_z))
    with profiler.span("rt.soft_pack"):
        tables = cuda_soft.soft_tables(scene, tau, tau_z)
        gates = cuda_soft.soft_gate_tables(scene, tau)
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (*scene.tensors(), *o, *d, tau, tau_z)
    ):
        rgb = cuda_soft._SoftTrace.apply(tables.counts, gates, depth, tables.packed, *o, *d)
    else:
        rgb, _ = cuda_soft.soft_levels(tables, gates, o, d, depth)
    return V3(*rgb)


def trace_soft_reference(scene: Scene, o: V3, d: V3, *, tau=0.02, tau_z=0.05,
                         depth: int = 0) -> V3:
    """``trace_soft`` with autograd straight through the plain level
    (``cuda_soft.soft_level_reference``) and no ``autograd.Function``: the
    yardstick of ``_SoftTrace``'s gradients. Any device, slow on large
    frames."""
    from raytracer_tpu_torch.ops import cuda_soft

    o, d = _planes(o, d)
    dev = d.x.device
    tau, tau_z = (torch.as_tensor(x, dtype=torch.float32, device=dev) for x in (tau, tau_z))
    tables = cuda_soft.soft_tables(scene, tau, tau_z)
    w = torch.ones_like(d.x)
    acc = V3(*(torch.zeros_like(w) for _ in range(3)))
    for k in range(depth + 1):
        acc, w, o, d, _ = cuda_soft.soft_level_reference(tables, o, d, w, acc, k == depth)
    return acc


def render_soft(scene: Scene, camera: Camera, width: int, height: int, *, tau=0.02,
                tau_z=0.05, tonemap: bool = True, depth: int = 0, device=None) -> torch.Tensor:
    """Soft-visibility render to ``[H, W, 3]``, the fit's forward pass:
    camera rays, ``trace_soft``, the Reinhard tone map. ``tau`` is the
    silhouette softness in world units, ``tau_z`` the depth-ordering
    softness; small values converge to the hard render. ``device=None``
    renders on CUDA."""
    dev = resolve_device(device)
    scene, camera = scene.to(dev), camera.to(dev)
    o, d = raygen_tile(camera, width, height)
    img = trace_soft(scene, o, d, tau=tau, tau_z=tau_z, depth=depth).stacked()
    return reinhard_tonemap(img) if tonemap else img
