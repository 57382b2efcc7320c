"""The entry points built on the port's closest-hit API, and their
gradients: ``render_depth`` and ``render(fold=...)`` against the JAX
package's, and the per-level bounce loop around ``closest_hit_soa``
(``trace_soa(closest_hit_fn=...)``, whose record comes from
``_ShortlistHit``) against the port's own whole-trace route and against
``jax.grad`` of the JAX loop around its record kernel (``_pallas_hit``).
Everything runs the kernels' plain versions on the CPU; the bars and the
FMA allowance of tests/test_torch_hit.py hold here too.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracer_tpu.core.types import Scene as JScene
from raytracer_tpu.core.v3 import V3 as JV3
from raytracer_tpu.models import scenes as jscenes
from raytracer_tpu.ops import pallas_fold as pf
from raytracer_tpu.ops import trace as jtrace
from raytracer_tpu.oracle.numpy_ref import scene_to_numpy
from raytracer_tpu.render import integrator as jint
from raytracer_tpu_torch import closest_hit_soa, render, render_depth
from raytracer_tpu_torch.core.types import Scene
from raytracer_tpu_torch.core.v3 import V3
from raytracer_tpu_torch.models import scenes as tscenes
from raytracer_tpu_torch.ops import cuda_fold, cuda_hit
from raytracer_tpu_torch.ops.trace import raygen_tile, trace_soa

torch.set_num_threads(1)

EPS32 = 2.0 ** -24


def _np(a):
    return np.array(a)


def _port(jscene):
    sn = scene_to_numpy(jscene, np.float32)
    return Scene.from_numpy(sn, device="cpu"), sn


def _camera_rays(w, h):
    """The demo camera's rays from the JAX raygen, float32 [6, h, w]."""
    o, d = jtrace.raygen_tile(jscenes.reference_demo_camera(), w, h)
    return np.stack([np.broadcast_to(_np(c), (h, w)) for c in (*o, *d)]).astype(np.float32)


def _tv(rays):
    return (V3(*(torch.from_numpy(np.ascontiguousarray(c)) for c in rays[:3])),
            V3(*(torch.from_numpy(np.ascontiguousarray(c)) for c in rays[3:])))


def _hit_fn(scene, o, d, active=None):
    """The port's closest hit with the default fold: ``_ShortlistHit``."""
    return closest_hit_soa(scene, o, d, active=active)


def _rel_slack(sn, rays, idx, t):
    """4 float32 ulps of the cancellation in the sphere root, relative to t
    (tests/test_torch_hit.py's ``_t_slack``)."""
    slack = np.zeros(t.shape, dtype=np.float64)
    sph = (idx >= 0) & (idx < len(sn["sph_radius"]))
    if sph.any():
        c = sn["sph_center"].astype(np.float64)[idx[sph]]
        r2 = sn["sph_radius"].astype(np.float64)[idx[sph]] ** 2
        ry = rays[:, sph].astype(np.float64)
        oc = ry[:3] - np.moveaxis(c, -1, 0)
        b = np.sum(ry[3:] * oc, axis=0)
        disc = b * b - (np.sum(oc * oc, axis=0) - r2)
        slack[sph] = 4 * EPS32 * 4 * b * b / np.sqrt(np.maximum(4 * disc, 1e-30)) / np.abs(t[sph])
    return slack


def _port_rays(w, h):
    """The port's demo-camera rays (its own raygen)."""
    return raygen_tile(tscenes.reference_demo_camera(device="cpu"), w, h)


def _rebuild(scene, leaves):
    """``scene`` with its tensor leaves replaced, in ``tensors()`` order."""
    it = iter(leaves)

    def swap(obj):
        kw = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            kw[f.name] = next(it) if isinstance(v, torch.Tensor) else swap(v)
        return obj.replace(**kw)

    return swap(scene)


@pytest.mark.parametrize("case", ["demo", "demo_row_chunk", "sky_only"])
def test_render_depth_matches_jax(case):
    """``render_depth`` against the JAX ``render_depth`` on the demo scene
    at 64x64, whole and in row chunks of 24 (which must give the whole
    frame's depths bit for bit), and on a scene without primitives (every
    pixel +inf): the same pixels finite on >= 99.9% of the frame, the
    depth within rtol 1e-5 plus the sphere root's cancellation slack on
    >= 99.9% of the pixels finite in both."""
    jscene = JScene.create() if case == "sky_only" else jscenes.reference_demo_scene()
    scene, sn = _port(jscene)
    cam = tscenes.reference_demo_camera(device="cpu")
    row_chunk = 24 if case == "demo_row_chunk" else 0
    want = _np(jint.render_depth(jscene, jscenes.reference_demo_camera(), 64, 64,
                                 row_chunk=row_chunk))
    got = render_depth(scene, cam, 64, 64, row_chunk=row_chunk, device="cpu").numpy()
    assert got.shape == (64, 64) and got.dtype == np.float32
    if case == "sky_only":
        assert np.isinf(got).all() and np.isinf(want).all()
        return
    both = np.isfinite(got) & np.isfinite(want)
    assert (np.isfinite(got) == np.isfinite(want)).mean() >= 0.999
    assert both.mean() > 0.05
    rays = _camera_rays(64, 64)
    idx = cuda_hit.fold_flat_reference(cuda_fold.fused_tables(scene), *_tv(rays))[1].numpy()
    rel = np.abs(got[both] - want[both].astype(np.float64)) / np.abs(want[both])
    assert (rel <= 1e-5 + _rel_slack(sn, rays[:, both], idx[both], want[both])).mean() >= 0.999
    if case == "demo_row_chunk":
        whole = render_depth(scene, cam, 64, 64, device="cpu").numpy()
        assert np.array_equal(got, whole)


def test_render_fold_selectors_match_jax():
    """``render(fold="pallas_flat")`` and ``render(fold="jnp")`` (the
    bounce loop level by level around the flat fold and around the plain
    fold) against the JAX ``render(fold="jnp")`` on the mixed scene at
    40x24, depth 2, to 5e-4 on all but 0.1% of pixels (the bar of
    tests/test_torch_trace.py); the two port selectors agree with each
    other and with the default route (the whole-trace kernel's plain
    version) bit for bit."""
    jscene = jscenes.mixed_primitive_scene()
    scene, _ = _port(jscene)
    cam = tscenes.reference_demo_camera(device="cpu")
    want = _np(jint.render(jscene, jscenes.reference_demo_camera(), 40, 24, depth=2,
                           tonemap=False, fold="jnp"))
    got = {f: render(scene, cam, 40, 24, depth=2, tonemap=False, fold=f, device="cpu").numpy()
           for f in ("pallas_flat", "jnp", "auto")}
    assert np.array_equal(got["pallas_flat"], got["jnp"])
    assert np.array_equal(got["pallas_flat"], got["auto"])
    off = ~np.isclose(got["jnp"], want, rtol=5e-4, atol=5e-4).all(axis=-1)
    assert off.mean() <= 1e-3, f"{off.sum()} pixels outside 5e-4"


def test_loop_gradients_match_whole_trace():
    """The loop around ``_ShortlistHit`` against the port's default route
    (``_WholeTrace``, its backward's plain version) on grid-64 at 48x32,
    depth 2: the same image bit for bit, and the gradient of a weighted sum
    of the image with respect to every scene leaf within 1e-4 of that
    leaf's largest entry (both are autograd of the same float32 ops, summed
    in another order: the record's gather adds per lane, the whole-trace
    backward per primitive in float64)."""
    base = tscenes.grid_sphere_scene(64, device="cpu")
    o, d = _port_rays(48, 32)
    weights = torch.cos(torch.arange(32 * 48 * 3, dtype=torch.float32)).reshape(3, 32, 48)
    grads, imgs = [], []
    for hit_fn in (_hit_fn, None):
        leaves = [t.detach().clone().requires_grad_(True) for t in base.tensors()]
        scene = _rebuild(base, leaves)
        img = trace_soa(scene, o, d, depth=2, closest_hit_fn=hit_fn)
        loss = sum((c * wt).sum() for c, wt in zip(img, weights))
        grads.append(torch.autograd.grad(loss, leaves, allow_unused=True))
        imgs.append(torch.stack(list(img)).detach())
    assert torch.equal(imgs[0], imgs[1])
    n_checked = 0
    for g_loop, g_whole in zip(*grads):
        if g_whole is None or not g_whole.numel():
            continue
        assert g_loop is not None and torch.isfinite(g_loop).all()
        scale = max(float(g_whole.abs().max()), 1e-6)
        assert float((g_loop - g_whole).abs().max()) <= 1e-4 * scale
        n_checked += 1
    assert n_checked >= 10


def test_loop_gradient_matches_jax_grad():
    """``jax.grad`` of the JAX loop around its record kernel
    (``trace_soa`` with a ``closest_hit_fn`` that takes ``_pallas_hit``,
    interpret mode, whose backward differentiates ``_mm_hit``) against the
    port's loop around ``_ShortlistHit``, on grid-64 at 32x16, depth 1, the
    same float32 rays: the gradient of a weighted image sum with respect to
    the sphere centres and colours within 1e-2 of its norm
    (tests/test_torch_train.py's bar: XLA's FMAs move grazing lanes)."""
    jscene = jscenes.grid_sphere_scene(64)
    scene, _ = _port(jscene)
    rays = _camera_rays(32, 16)
    weights = np.cos(np.arange(16 * 32 * 3, dtype=np.float32)).reshape(3, 16, 32)
    jfold = functools.partial(pf.fold_closest_pallas_shortlist, interpret=True)
    jfold._emits_hit_record = True

    def j_hit(sc, o, d, active=None):
        return jtrace.closest_hit_soa(sc, o, d, fold_fn=jfold, active=active)

    def j_loss(center, color):
        sc = jscene.replace(spheres=jscene.spheres.replace(
            center=center, material=jscene.spheres.material.replace(color=color)))
        img = jtrace.trace_soa(sc, JV3(*(jnp.asarray(c) for c in rays[:3])),
                               JV3(*(jnp.asarray(c) for c in rays[3:])), depth=1,
                               closest_hit_fn=j_hit)
        return sum(jnp.sum(c * wt) for c, wt in zip(img, weights))

    want = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(jscene.spheres.center,
                                                     jscene.spheres.material.color)
    center = scene.spheres.center.clone().requires_grad_(True)
    color = scene.spheres.material.color.clone().requires_grad_(True)
    sc = scene.replace(spheres=scene.spheres.replace(
        center=center, material=scene.spheres.material.replace(color=color)))
    img = trace_soa(sc, *_tv(rays), depth=1, closest_hit_fn=_hit_fn)
    loss = sum((c * torch.from_numpy(wt)).sum() for c, wt in zip(img, weights))
    got = torch.autograd.grad(loss, [center, color])
    for g, w in zip(got, want):
        g, w = g.numpy(), _np(w)
        assert np.isfinite(g).all()
        assert np.linalg.norm(g - w) <= 1e-2 * np.linalg.norm(w), (g, w)


def test_all_miss_gradients_finite():
    """Every sphere moved 1e4 behind the camera (tests/test_pallas_fold.py's
    all-miss scene): the loop's gradient with respect to the centres is
    finite (zero) through ``_ShortlistHit`` and through the flat fold with
    ``hit_record``: the record's strict ``det > 0`` keeps sqrt'(0) out of
    the backward. The record's own t gradient is finite too."""
    base = tscenes.reference_demo_scene(device="cpu")
    cam = tscenes.reference_demo_camera(device="cpu")
    o, d = _port_rays(32, 24)
    for fold in ("record", "pallas_flat"):
        c = (base.spheres.center + 1e4).requires_grad_(True)
        sc = base.replace(spheres=base.spheres.replace(center=c))
        if fold == "record":
            img = trace_soa(sc, o, d, depth=2, closest_hit_fn=_hit_fn)
        else:
            img = render(sc, cam, 32, 24, depth=2, tonemap=False, fold=fold, device="cpu")
            img = V3(*img.unbind(-1))
        (g,) = torch.autograd.grad(sum((ch ** 2).mean() for ch in img), c)
        assert torch.isfinite(g).all(), fold
        rec = closest_hit_soa(sc, o, d)
        assert not (rec.hit & (rec.prim_index < len(base.spheres))).any()
        (gt,) = torch.autograd.grad(rec.t.sum() + rec.point.x.sum(), c, allow_unused=True)
        assert gt is None or torch.isfinite(gt).all()
