"""The per-level chain's backward (its plain version, which is what
``trace_levels_bwd`` runs on CPU tensors) against the JAX package's
per-level backward kernels, against the port's whole-trace backward, and the
chain's wiring: ``_LevelTrace``, the route ``trace_soa`` takes, ragged tiles
and the wrappers' input checks. CPU only.

Against JAX, both sides get the JAX per-level chain's own residuals (each
level's input rays, throughput, t and index) and one seeded image
cotangent, with tests/test_torch_grad.py's exclusions: grazing sphere hits,
lanes whose replayed t differs from the saved one (XLA's FMA contraction)
and lanes whose replayed normal leaves unit by more than 1e-3 (the JAX
chain's bounce drifting off unit, which the port's unit bounce does not
follow) get a zero image cotangent on both sides. Then every scene leaf
agrees to 1e-3 of its largest entry and the ray cotangents to rtol 1e-3 plus
1e-4 of the plane's largest entry on all but 0.1% of lanes, after
test_torch_grad.py's projections: the camera direction's cotangent without
its component along the direction, the walls' normal without its own
component along the normal (the port's bounce takes both as unit, so
neither component moves it; the JAX kernel's does).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracer_tpu.core.v3 import V3 as JV3
from raytracer_tpu.models import scenes as jscenes
from raytracer_tpu.ops.pallas_fold import trace_levels_pallas, trace_levels_pallas_bwd
from raytracer_tpu.ops.trace import raygen_tile as j_raygen_tile
from raytracer_tpu.oracle.numpy_ref import scene_to_numpy
from raytracer_tpu_torch import render
from raytracer_tpu_torch.core.types import Scene
from raytracer_tpu_torch.core.v3 import V3
from raytracer_tpu_torch.models import scenes as tscenes
from raytracer_tpu_torch.ops import cuda_fold, cuda_level
from raytracer_tpu_torch.ops.trace import raygen_tile, trace_soa
from raytracer_tpu_torch.utils.profiler import launches
from test_torch_grad import (H, W, _direct_trace, _excluded_lanes, compared_leaf, compared_rays,
                             leaf_grads)

torch.set_num_threads(1)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _frame(w, h):
    """The demo camera's rays and unit throughput as ``[h, w]`` planes."""
    o, d = raygen_tile(tscenes.reference_demo_camera(device="cpu"), w, h)
    return o.broadcast_to(d.x.shape), d.broadcast_to(d.x.shape), torch.ones(d.x.shape)


@pytest.fixture(scope="module")
def backward_pair():
    """One JAX forward with residuals and one JAX per-level backward on
    grid-130 (9 chunks: the JAX chain keeps one 32-row tiling) at depth 2,
    and the port's plain per-level backward on the same inputs."""
    depth = 2
    jscene = jscenes.grid_sphere_scene(130)
    o, d = j_raygen_tile(jscenes.reference_demo_camera(), W, H)
    o = JV3(*(jnp.broadcast_to(c, d.x.shape) for c in o))
    _, ts, idxs, rays, ws, sls = trace_levels_pallas(jscene, o, d, depth=depth,
                                                     with_residuals=True)
    sn = scene_to_numpy(jscene, np.float32)
    scene = Scene.from_numpy(sn, device="cpu")
    tables = cuda_fold.fused_tables(scene)
    attrs, ls = (a.detach() for a in cuda_fold.attribute_tables(scene))
    excluded = _excluded_lanes(sn, tables, attrs, rays, ws, ts, idxs, depth)
    ct = np.random.default_rng(11).normal(size=(3, H, W)).astype(np.float32)
    ct[:, excluded] = 0.0
    scene_ct, ct_o, ct_d = trace_levels_pallas_bwd(
        jscene, ts, idxs, rays, ws, sls, JV3(*(jnp.asarray(c) for c in ct)), depth=depth,
    )
    levels = cuda_fold.Residuals(
        V3(*(_t(c) for c in rays[0][:3])), V3(*(_t(c) for c in rays[0][3:])), _t(ws[0]),
        torch.stack([_t(t) for t in ts]), torch.stack([_t(i) for i in idxs]),
        torch.stack([torch.stack([_t(c) for c in (*rays[k], ws[k])])
                     for k in range(1, depth + 1)]),
    )
    p_o, p_d, _, p_attrs, p_ls = cuda_level.trace_levels_bwd(
        tables, attrs, ls, levels, V3(*(torch.from_numpy(c) for c in ct)), depth
    )
    return dict(
        sn=sn, excluded=excluded, jax_leaves=scene_to_numpy(scene_ct, np.float32),
        port_leaves=leaf_grads(scene, p_attrs, p_ls),
        jax_rays=[np.asarray(c) for c in (*ct_o, *ct_d)],
        port_rays=[c.numpy() for c in (*p_o, *p_d)],
        d0=np.stack([np.asarray(c) for c in rays[0][3:]]),
    )


def test_scene_cotangents_match_jax_level_bwd(backward_pair):
    r = backward_pair
    assert r["excluded"].mean() <= 0.1
    n_checked = 0
    for key, want in r["jax_leaves"].items():
        got = r["port_leaves"][key]
        assert got.shape == want.shape, key
        if not want.size:
            continue
        assert np.isfinite(got).all(), key
        got, want = compared_leaf(r["sn"], key, got, want)
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * scale + 1e-12, err_msg=key)
        n_checked += scale > 0
    assert n_checked >= 15


def test_ray_cotangents_match_jax_level_bwd(backward_pair):
    r = backward_pair
    port, jax = compared_rays(r["d0"], r["port_rays"], r["jax_rays"])
    for name, got, want in zip(("o.x", "o.y", "o.z", "d.x", "d.y", "d.z"), port, jax):
        assert np.isfinite(got).all(), name
        off = ~np.isclose(got, want, rtol=1e-3, atol=1e-4 * np.abs(want).max())
        assert off.mean() <= 1e-3, f"{name}: {off.sum()} lanes off"


@pytest.mark.parametrize(
    "make, depth",
    [(lambda: tscenes.grid_sphere_scene(1024, device="cpu"), 2),
     (lambda: tscenes.sprint3_scene(device="cpu"), 11)],
    ids=["grid1024_d2", "sprint3_d11"],
)
def test_level_trace_gradient_equals_direct_autograd(make, depth):
    """``trace_soa`` outside the whole-trace class, with leaves that require
    grad, goes through ``_LevelTrace``; its image and gradient equal
    autograd straight through ``_level_math`` at the same selections."""
    scene = make()
    leaves = list(scene.tensors())
    for t in leaves:
        t.requires_grad_(True)
    o, d = raygen_tile(tscenes.reference_demo_camera(device="cpu"), 40, 24)
    o, d = o.broadcast_to(d.x.shape), d.broadcast_to(d.x.shape)
    d = V3(*(c.clone().requires_grad_(True) for c in d))
    ct = torch.from_numpy(np.random.default_rng(2).normal(size=(3, 24, 40)).astype(np.float32))
    counters = ("trace_whole_bwd", "trace_level_bwd")
    before = [launches(k) for k in counters]
    got_img = trace_soa(scene, o, d, depth=depth)
    assert type(got_img.x.grad_fn).__name__.startswith("_LevelTrace")
    want_img = _direct_trace(scene, o, d, depth)
    for a, b in zip(got_img, want_img):
        assert torch.equal(a, b)
    wrt = leaves + list(d)
    got = torch.autograd.grad(sum((a * c).sum() for a, c in zip(got_img, ct)), wrt, allow_unused=True)
    want = torch.autograd.grad(sum((a * c).sum() for a, c in zip(want_img, ct)), wrt, allow_unused=True)
    assert [launches(k) for k in counters] == before
    n_nonzero = 0
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is None or not g.numel():
            continue
        assert torch.isfinite(g).all()
        n_nonzero += bool(w.abs().max() > 0)
        torch.testing.assert_close(g, w, rtol=0, atol=1e-6 * float(w.abs().max()))
    assert n_nonzero >= 15


@pytest.mark.parametrize(
    "make, depth",
    [(lambda: tscenes.grid_sphere_scene(64, device="cpu"), 3),
     (lambda: tscenes.mixed_primitive_scene(device="cpu"), 2)],
    ids=["grid64_d3", "mixed_d2"],
)
def test_level_bwd_equals_whole_bwd(make, depth):
    """On the same residuals the per-level backward is the whole-trace
    backward's plain version, level for level: equal outputs."""
    scene = make()
    tables = cuda_fold.fused_tables(scene)
    attrs, ls = (a.detach() for a in cuda_fold.attribute_tables(scene))
    o, d = raygen_tile(tscenes.reference_demo_camera(device="cpu"), 48, 32)
    o, d = o.broadcast_to(d.x.shape), d.broadcast_to(d.x.shape)
    w = torch.ones(d.x.shape)
    _, t, i, res = cuda_level.trace_levels(tables, o, d, w, depth, emit_res=True)
    levels = cuda_fold.Residuals(o, d, w, t, i, res)
    gen = torch.Generator().manual_seed(5)
    ct = V3(*(torch.randn(w.shape, generator=gen) for _ in range(3)))
    got = cuda_level.trace_levels_bwd(tables, attrs, ls, levels, ct, depth)
    want = cuda_fold.trace_whole_bwd_reference(tables, attrs, ls, levels, ct, depth)
    for a, b in zip((*got[0], *got[1], *got[2:]), (*want[0], *want[1], *want[2:])):
        assert torch.equal(a, b)
    assert float(got[3].abs().max()) > 0 and float(got[4].abs().max()) > 0


def test_level_route_all_miss_gradients_finite():
    """The 1024-sphere grid with its spheres (and then walls) out of view:
    the per-level route's gradient is finite, and exactly 0 for the unseen
    spheres."""
    cam = tscenes.reference_demo_camera(device="cpu")
    base = tscenes.grid_sphere_scene(1024, device="cpu")
    far = base.spheres.center + 1e4
    for scene in (base, base.replace(walls=base.walls.replace(position=base.walls.position + 1e4))):
        center = far.clone().requires_grad_(True)
        sky = scene.sky.zenith_color.clone().requires_grad_(True)
        sc = scene.replace(spheres=scene.spheres.replace(center=center),
                           sky=scene.sky.replace(zenith_color=sky))
        img = render(sc, cam, 40, 24, depth=2, tonemap=False, device="cpu")
        gc, gs = torch.autograd.grad(torch.mean(img ** 2), (center, sky))
        assert torch.isfinite(gc).all() and torch.isfinite(gs).all()
        assert float(gc.abs().max()) == 0.0 and float(gs.abs().max()) > 0.0


def test_fit_step_on_level_route_with_optimizer():
    """``make_fit_step`` on the 1024-sphere grid (the per-level route) with
    an ``optimizer`` per parameter: the colours move and the loss falls, the
    centers (learning rate 0) stay, and the plain versions count no kernel
    launch."""
    from raytracer_tpu_torch import default_params, make_fit_step, merge_params

    scene = tscenes.grid_sphere_scene(1024, device="cpu")
    cam = tscenes.reference_demo_camera(device="cpu")
    with torch.no_grad():
        target = render(scene, cam, 40, 24, depth=2, device="cpu")
    p = default_params(scene)
    start = merge_params(scene, {"color": torch.clamp_min(p["color"] - 0.2, 0.0)})
    init_fn, step_fn = make_fit_step(
        40, 24, depth=2, device="cpu",
        optimizer=lambda q: torch.optim.Adam([{"params": [q["color"]], "lr": 2e-2},
                                              {"params": [q["center"]], "lr": 0.0}]),
    )
    state = init_fn(start)
    before = launches("trace_level_bwd")
    losses = [float(step_fn(state, start, cam, target)[1]) for _ in range(3)]
    assert losses[-1] < losses[0] and np.isfinite(losses).all()
    assert torch.equal(state.params["center"], start.spheres.center)
    assert not torch.equal(state.params["color"], start.spheres.material.color)
    assert float(state.params["center"].grad.abs().max()) > 0
    assert launches("trace_level_bwd") == before


def test_trace_soa_cpu_runs_plain_chain():
    """trace_soa on CPU tensors of the 1024-sphere grid (a table past the
    whole-trace class) takes the per-level route (its plain versions) and
    counts no kernel launch."""
    scene = tscenes.grid_sphere_scene(1024, device="cpu")
    tables = cuda_fold.fused_tables(scene)
    assert not cuda_fold.in_fused_class(tables, 2)
    o, d, ones = _frame(48, 24)
    counters = ("trace_whole", "ray_stats", "trace_level", "trace_level_bwd")
    before = [launches(k) for k in counters]
    acc = trace_soa(scene, o, d, depth=2)
    want, _, _ = cuda_level.trace_levels(tables, o, d, ones, 2)
    assert all(torch.equal(a, b) for a, b in zip(acc, want))
    assert [launches(k) for k in counters] == before


def test_ragged_tiles_count_real_lanes():
    """A frame whose sides are not multiples of the tile: each partial tile's
    stats are those of the same frame padded with dead lanes, and the
    per-level route needs no padded planes."""
    tables = cuda_fold.fused_tables(tscenes.grid_sphere_scene(130, device="cpu"))
    o, d, ones = _frame(45, 19)
    got = cuda_level.ray_stats_reference(tables, o, d, ones, (8, 32))
    padded = [torch.nn.functional.pad(c, (0, 64 - 45, 0, 24 - 19)) for c in (*o, *d, ones)]
    want = cuda_level.ray_stats_reference(tables, V3(*padded[:3]), V3(*padded[3:6]),
                                          padded[6], (8, 32))
    assert got.shape == want.shape == (3 * 2, cuda_level.NSTAT + 9)
    assert torch.equal(got, want)
    assert int(got[:, 9].sum()) <= 45 * 19


def test_level_checks_inputs():
    tables = cuda_fold.fused_tables(tscenes.grid_sphere_scene(80, device="cpu"))
    o, d, ones = _frame(40, 16)
    zero = V3(*(torch.zeros_like(ones) for _ in range(3)))
    t = torch.empty_like(ones)
    i = torch.empty(ones.shape, dtype=torch.int32)
    sl = cuda_level.phase_a(cuda_level.ray_stats(tables, o, d, ones), tables)
    _, th, tw = cuda_level.tile_grid((16, 40))
    assert sl[0].shape == (th * tw, 5) and sl[0].dtype == torch.int32
    with pytest.raises(ValueError, match="int32"):
        cuda_level.trace_level(tables, sl, o, d, ones, zero, t, i.long(), None, True)
    with pytest.raises(ValueError, match="shape"):
        cuda_level.trace_level(tables, (sl[0][:-1], sl[1]), o, d, ones, zero, t, i, None, True)
    with pytest.raises(ValueError, match="stats"):
        cuda_level.trace_level(tables, sl, o, d, ones, zero, t, i, None, True, want_stats=True)
    with pytest.raises(ValueError, match="negative"):
        cuda_level.trace_levels(tables, o, d, ones, -1)
    with pytest.raises(ValueError, match=r"\[H, W\]"):
        cuda_level.trace_levels(tables, V3(*(c[0] for c in o)), V3(*(c[0] for c in d)),
                                ones[0], 1)
