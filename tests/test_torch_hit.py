"""The port's closest-hit API (its kernels' plain versions, which are what
``fold_flat``, ``fold_shortlist`` and ``fold_shortlist_hit`` run on CPU
tensors) against the JAX package's: the three Pallas folds in interpret
mode, ``fold_closest_jnp`` and ``closest_hit_soa`` under each fold selector.
The entry points built on them (``render_depth``, ``render(fold=...)``)
and the gradients are in tests/test_torch_hit_grad.py.

Both packages get the same float32 rays and scenes (``scene_to_numpy``).
XLA contracts multiply-adds into FMAs where the port rounds every op, so the
bars are those of tests/test_torch_trace.py: hit indices agree on >= 99.9%
of the lanes compared (on these small frames, all but 0.1% of them plus 2)
and every lane that differs is a grazing sphere hit;
t agrees to rtol 1e-5 plus 4 float32 ulps of the cancellation in the sphere
root (``_t_slack``). The hit record is held to the JAX package's own test
of its record kernel (tests/test_pallas_fold.py:160-201): materials exact
on the hit lanes whose indices agree, t, point and normal within 2e-3. The
JAX shortlist folds may return anything on inactive lanes, so only active
lanes are compared; the port's are a miss record.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracer_tpu.core.types import Materials as JMaterials
from raytracer_tpu.core.types import Scene as JScene
from raytracer_tpu.core.types import Walls as JWalls
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
from raytracer_tpu_torch.ops.trace import MISS_T, resolve_fold_fn, trace_soa

torch.set_num_threads(1)

W, H = 64, 32  # interpret-mode frames stay at most 64x32
EPS32 = 2.0 ** -24


def _np(a):
    return np.array(a)


def _port(jscene):
    """The port's copy of a JAX scene and its numpy form."""
    sn = scene_to_numpy(jscene, np.float32)
    return Scene.from_numpy(sn, device="cpu"), sn


def _camera_rays(w=W, h=H):
    """The demo camera's rays from the JAX raygen, as float32 numpy planes
    [6, h, w] (the origin broadcast)."""
    o, d = jtrace.raygen_tile(jscenes.reference_demo_camera(), w, h)
    return np.stack([np.broadcast_to(_np(c), (h, w)) for c in (*o, *d)]).astype(np.float32)


def _jv(rays):
    return JV3(*(jnp.asarray(c) for c in rays[:3])), JV3(*(jnp.asarray(c) for c in rays[3:]))


def _tv(rays):
    return (V3(*(torch.from_numpy(np.ascontiguousarray(c)) for c in rays[:3])),
            V3(*(torch.from_numpy(np.ascontiguousarray(c)) for c in rays[3:])))


def _sphere_terms(sn, rays, idx):
    """float64 (disc/r^2, bq^2, det) of each lane's ray against sphere
    ``idx`` (the half-b discriminant and the full-form terms)."""
    c = sn["sph_center"].astype(np.float64)[idx]
    r2 = sn["sph_radius"].astype(np.float64)[idx] ** 2
    rays = rays.astype(np.float64)
    oc = rays[:3] - np.moveaxis(c, -1, 0)
    b = np.sum(rays[3:] * oc, axis=0)
    disc = b * b - (np.sum(oc * oc, axis=0) - r2)
    return disc / r2, 4.0 * b * b, 4.0 * disc


def _grazing(sn, rays, y, x, cands) -> bool:
    """A sphere among the candidate indices is met at |disc| < 1e-2 r^2."""
    n_s = len(sn["sph_radius"])
    return any(0 <= i < n_s and abs(_sphere_terms(sn, rays[:, y, x], np.int64(i))[0]) < 1e-2
               for i in cands)


def _t_slack(sn, rays, idx, t):
    """Relative slack of t per lane: 4 float32 ulps of the cancellation in
    the sphere root (its discriminant is a difference of terms near bq^2)."""
    slack = np.zeros(t.shape, dtype=np.float64)
    sph = (idx >= 0) & (idx < len(sn["sph_radius"]))
    if sph.any():
        _, bq2, det = _sphere_terms(sn, rays[:, sph], idx[sph])
        slack[sph] = 4 * EPS32 * bq2 / np.sqrt(np.maximum(det, 1e-30)) / np.abs(t[sph])
    return slack


def _check_fold(sn, rays, ji, jt, pi, pt, mask=None):
    """The bars of the module docstring on the lanes of ``mask``; returns
    the lanes whose indices agree."""
    mask = np.ones(ji.shape, bool) if mask is None else mask
    diff = mask & (ji != pi)
    assert diff.sum() <= 1e-3 * mask.sum() + 2, f"{diff.sum()} of {mask.sum()} lanes differ"
    for y, x in zip(*np.nonzero(diff)):
        assert _grazing(sn, rays, y, x, (ji[y, x], pi[y, x])), (y, x, ji[y, x], pi[y, x])
    agree = mask & (ji == pi)
    hit = agree & (ji >= 0)
    jt64 = jt[hit].astype(np.float64)
    rel = np.abs(pt[hit] - jt64) / np.abs(jt64)
    bad = rel > 1e-5 + _t_slack(sn, rays[:, hit], ji[hit], jt64)
    assert not bad.any(), f"{bad.sum()} lanes, worst rel {rel.max():.3g}"
    assert (pt[agree & (ji < 0)] == np.float32(MISS_T)).all()
    return agree


def _walls_only():
    walls = JWalls.create(
        position=[[3.0, 2.0, 0.0], [3.0, -3.0, 0.0]],
        normal=[[0.0, -1.0, 0.0], [0.0, 1.0, 0.0]],
        length=[1.0, 2.0], width=[1.0, 2.0],
        material=JMaterials.create([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]),
    )
    return JScene.create(walls=walls)


@pytest.mark.parametrize("case", ["mixed_kernel", "grid64_jnp", "random_rays_jnp"])
def test_fold_flat_matches_jax(case):
    """``fold_flat_reference`` against the JAX brute-force fold kernel
    (``fold_closest_pallas``, interpret mode) on the mixed scene's camera
    rays, and against ``fold_closest_jnp`` on grid-64's camera rays and on
    seeded random unit rays of a ragged 23x37 shape from random origins."""
    jscene = jscenes.mixed_primitive_scene() if case == "mixed_kernel" else jscenes.grid_sphere_scene(64)
    scene, sn = _port(jscene)
    if case == "random_rays_jnp":
        g = np.random.default_rng(5)
        d = g.normal(size=(3, 23, 37))
        d /= np.linalg.norm(d, axis=0)
        o = g.uniform(-1.0, 1.0, size=(3, 23, 37)) + np.array([-2.0, 0.0, 0.5])[:, None, None]
        rays = np.concatenate([o, d]).astype(np.float32)
    else:
        rays = _camera_rays()
    jo, jd = _jv(rays)
    if case == "mixed_kernel":
        jt, ji = pf.fold_closest_pallas(jscene, jo, jd, interpret=True)
    else:
        jt, ji = jtrace.fold_closest_jnp(jscene, jo, jd)
    pt, pi = cuda_hit.fold_flat_reference(cuda_fold.fused_tables(scene), *_tv(rays))
    agree = _check_fold(sn, rays, _np(ji), _np(jt), pi.numpy(), pt.numpy())
    assert (_np(ji) >= 0)[agree].mean() > 0.1  # the frame hits something


@pytest.fixture(scope="module")
def grid64():
    jscene = jscenes.grid_sphere_scene(64)
    scene, sn = _port(jscene)
    return jscene, scene, sn, _camera_rays()


@pytest.mark.parametrize("masked", [False, True])
def test_fold_shortlist_matches_jax_kernel(grid64, masked):
    """``fold_shortlist_reference`` (with the shortlists the scene-level
    entry point builds: stats and phase A on the active lanes) against the
    JAX shortlist fold kernel on grid-64, without and with a seeded
    ``active`` mask; dead lanes are the port's miss record."""
    jscene, scene, sn, rays = grid64
    active = np.random.default_rng(3).uniform(size=(H, W)) < 0.6 if masked else None
    jo, jd = _jv(rays)
    jt, ji = pf.fold_closest_pallas_shortlist(
        jscene, jo, jd, active=None if active is None else jnp.asarray(active), interpret=True)
    o, d = _tv(rays)
    t_act = None if active is None else torch.from_numpy(active)
    pt, pi = cuda_hit.fold_closest_shortlist(scene, o, d, active=t_act)
    mask = np.ones((H, W), bool) if active is None else active
    _check_fold(sn, rays, _np(ji), _np(jt), pi.numpy(), pt.numpy(), mask)
    assert (pi.numpy()[~mask] == -1).all() and (pt.numpy()[~mask] == np.float32(MISS_T)).all()


def test_fold_shortlist_walls_only_and_all_dead():
    """A sphere-free scene through the shortlist fold (identity lists, no
    stats) against the JAX kernel; an all-dead mask gives every lane a miss
    record, in the fold and in the hit record."""
    jscene = _walls_only()
    scene, sn = _port(jscene)
    rays = _camera_rays()
    jt, ji = pf.fold_closest_pallas_shortlist(jscene, *_jv(rays), interpret=True)
    o, d = _tv(rays)
    pt, pi = cuda_hit.fold_closest_shortlist(scene, o, d)
    _check_fold(sn, rays, _np(ji), _np(jt), pi.numpy(), pt.numpy())
    assert (_np(ji) >= 0).any()
    dead = torch.zeros((H, W), dtype=torch.bool)
    for s in (scene, _port(jscenes.grid_sphere_scene(64))[0]):
        t, i = cuda_hit.fold_closest_shortlist(s, o, d, active=dead)
        assert (i == -1).all() and (t == np.float32(MISS_T)).all()
        rec = cuda_hit.hit_closest_shortlist(s, o, d, active=dead)
        assert (rec[1] == -1).all() and (rec[7] == 1.0).all() and (rec[8] == 0.0).all()
        assert torch.equal(rec[2], o.x + d.x)


@pytest.mark.parametrize("which", ["grid64", "mixed"])
def test_hit_record_matches_jax_kernel(grid64, which):
    """``fold_shortlist_hit_reference`` against the JAX record kernel
    (``_kernel_hit_record``: ``hit_closest_pallas_shortlist`` in interpret
    mode), with the bars of the JAX package's own test of that kernel."""
    if which == "grid64":
        jscene, scene, sn, rays = grid64
    else:
        jscene = jscenes.mixed_primitive_scene()
        scene, sn = _port(jscene)
        rays = _camera_rays()
    jo, jd = _jv(rays)
    rec = jtrace._kernel_hit_record(jscene, jo, jd, None)
    tables = cuda_fold.fused_tables(scene)
    o, d = _tv(rays)
    w = torch.ones((H, W))
    planes = [p.numpy() for p in cuda_hit.fold_shortlist_hit_reference(
        tables, cuda_hit.shortlists(tables, o, d, w), o, d, w)]
    ji = _np(rec.prim_index)
    agree = _check_fold(sn, rays, ji, _np(rec.t), planes[1], planes[0])
    hit = agree & (ji >= 0)
    assert hit.mean() > 0.1
    exact = [*rec.color, rec.ambient, rec.metallic, rec.diffuse, rec.specular,
             rec.specular_exponent]
    for k, jp in enumerate(exact):
        np.testing.assert_array_equal(planes[8 + k][hit], _np(jp)[hit])
    for k, jp in enumerate([*rec.point, *rec.normal]):
        np.testing.assert_allclose(planes[2 + k][hit], _np(jp)[hit], atol=2e-3)


def test_closest_hit_soa_matches_jax():
    """``closest_hit_soa`` with each selector's fold against the JAX
    ``closest_hit_soa`` with the same selector's, on the mixed scene (the
    port's default and ``pallas`` take the record kernel, ``pallas_flat``
    the flat fold and ``hit_record``, ``jnp`` the plain fold and
    ``hit_record``)."""
    import functools

    jscene = jscenes.mixed_primitive_scene()
    scene, sn = _port(jscene)
    rays = _camera_rays()
    jo, jd = _jv(rays)
    jo = JV3(*(jnp.broadcast_to(c, (H, W)) for c in jo))
    o, d = _tv(rays)
    for fold in ("auto", "pallas", "pallas_flat", "jnp"):
        jfold = jtrace.resolve_fold_fn(fold, 64, jscene.num_primitives)
        if fold in ("pallas", "pallas_flat"):  # interpret mode on the CPU
            jfold = functools.partial(jfold, interpret=True)
        want = jtrace.closest_hit_soa(jscene, jo, jd, fold_fn=jfold)
        got = closest_hit_soa(scene, o, d, fold_fn=resolve_fold_fn(fold))
        ji = _np(want.prim_index)
        agree = _check_fold(sn, rays, ji, _np(want.t), got.prim_index.numpy(), got.t.numpy())
        hit = agree & (ji >= 0)
        assert np.array_equal(got.hit.numpy()[agree], _np(want.hit)[agree]), fold
        for name in ("color", "ambient", "metallic", "diffuse", "specular",
                     "specular_exponent"):
            g, w = getattr(got, name), getattr(want, name)
            for a, b in (zip(g, w) if name == "color" else ((g, w),)):
                np.testing.assert_array_equal(a.numpy()[hit], _np(b)[hit], err_msg=fold + name)
        for name in ("point", "normal"):
            for a, b in zip(getattr(got, name), getattr(want, name)):
                np.testing.assert_allclose(a.numpy()[hit], _np(b)[hit], atol=2e-3,
                                           err_msg=fold + name)


def test_selectors_and_wrappers():
    """The selector names map to their folds and an unknown one raises (in
    ``resolve_fold_fn``, ``trace_soa`` and ``render``); the shortlist fold
    carries the record tag; on CPU tensors the wrappers run their plain
    versions and count no launch; a plane of another type or layout is
    refused."""
    assert resolve_fold_fn("auto") is cuda_hit.fold_closest_shortlist
    assert resolve_fold_fn("pallas") is cuda_hit.fold_closest_shortlist
    assert resolve_fold_fn("pallas_flat") is cuda_hit.fold_closest_flat
    assert cuda_hit.fold_closest_shortlist._emits_hit_record
    assert not getattr(cuda_hit.fold_closest_flat, "_emits_hit_record", False)
    scene = tscenes.sprint3_scene(device="cpu")
    rays = _camera_rays(16, 8)
    o, d = _tv(rays)
    for bad in ("xla", "Pallas", ""):
        with pytest.raises(ValueError, match="unknown fold"):
            resolve_fold_fn(bad)
        with pytest.raises(ValueError, match="unknown fold"):
            trace_soa(scene, o, d, depth=1, fold=bad)
        with pytest.raises(ValueError, match="unknown fold"):
            render(scene, tscenes.reference_demo_camera(device="cpu"), 8, 4, fold=bad, device="cpu")
    tables = cuda_fold.fused_tables(scene)
    w = torch.ones((8, 16))
    before = [f.launches for f in (cuda_hit.fold_flat, cuda_hit.fold_shortlist,
                                   cuda_hit.fold_shortlist_hit)]
    t, i = cuda_hit.fold_flat(tables, o, d)
    t2, i2 = cuda_hit.fold_shortlist(tables, None, o, d, w)
    rec = cuda_hit.fold_shortlist_hit(tables, None, o, d, w)
    assert torch.equal(i, i2) and torch.equal(t, t2) and torch.equal(rec[1], i)
    assert before == [f.launches for f in (cuda_hit.fold_flat, cuda_hit.fold_shortlist,
                                           cuda_hit.fold_shortlist_hit)]
    with pytest.raises(ValueError, match="float32"):
        cuda_hit.fold_flat(tables, o, V3(d.x.double(), d.y, d.z))
    with pytest.raises(ValueError, match="contiguous"):
        cuda_hit.fold_shortlist(tables, None, o, V3(d.x, d.y, torch.zeros(16, 8).t()), w)
    with pytest.raises(ValueError, match=r"\[H, W\]"):
        cuda_hit.fold_shortlist(tables, None, V3(*(c.reshape(-1) for c in o)),
                                V3(*(c.reshape(-1) for c in d)), w.reshape(-1))
