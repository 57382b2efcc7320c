"""The hard path's mirror bounce, the upstream's ``reflect``, on every hard
route's plain version, and the span of the per-level backward.

The port bounces a hit with ``d^ - 2 (d^ . n^) n^``, the incoming direction
and the normal each made unit (``cuda_fold._bounce``), and leaves the hit
point by ``REFLECT_EPS`` along n^. Rays planted to graze the spheres of a
grid, and the grid's camera frame, keep every level's direction unit to
1e-6 to depth 4 on the three routes (the whole trace, the per-level chain
and the per-level loop around a closest-hit function); with the old
``d - 2 (d . n) n`` put back they do not, since the sphere root takes the
direction as unit and a float32 normal is off unit by up to ~4e-5.

CPU only, no JAX: the plain versions, which are what the kernels' wrappers
run on CPU tensors, on tiny frames.
"""

import numpy as np
import pytest
import torch

from raytracer_tpu_torch import make_fit_step
from raytracer_tpu_torch.core.v3 import V3
from raytracer_tpu_torch.models import scenes as tscenes
from raytracer_tpu_torch.ops import cuda_fold, cuda_level
from raytracer_tpu_torch.ops.trace import REFLECT_EPS, closest_hit_soa, raygen_tile, trace_soa
from raytracer_tpu_torch.utils import profiler

DEPTH = 4
ROUTES = ("whole", "chain", "loop")
# The smallest grid scene outside the whole-trace class: its fit steps take
# the per-level chain and ``_LevelTrace``.
GRID_PAST_CLASS = 769


@pytest.fixture(scope="module")
def grid():
    return tscenes.grid_sphere_scene(64, device="cpu")


@pytest.fixture(scope="module")
def rays(grid):
    """``[40, 64]`` planes: rays from the demo camera's eye that pass each
    of the grid's 64 spheres at 0.9 to 0.99999 of its radius from its
    centre, on 8 sides of it, then the camera's own 48x24 frame below
    them."""
    eye = tscenes.reference_demo_camera(device="cpu").position.double()
    c = grid.spheres.center.double()
    r = grid.spheres.radius.double()
    axis = c - eye
    axis = axis / axis.norm(dim=-1, keepdim=True)
    u = torch.linalg.cross(axis, torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64)[None])
    u = u / u.norm(dim=-1, keepdim=True)
    v = torch.linalg.cross(axis, u)
    impact = torch.tensor([0.9, 0.99, 0.999, 0.9999, 0.99999], dtype=torch.float64)
    phi = torch.arange(8, dtype=torch.float64) * (np.pi / 4)
    side = (torch.cos(phi)[:, None, None] * u[None] + torch.sin(phi)[:, None, None] * v[None])
    aim = c[None, None] + (impact[:, None, None, None] * r[None, None, :, None]) * side[None]
    d = aim - eye
    d = (d / d.norm(dim=-1, keepdim=True)).float().reshape(-1, 3)  # 5 * 8 * 64 rays
    o, d_cam = raygen_tile(tscenes.reference_demo_camera(device="cpu"), 48, 24)
    planted = V3(*(d[:, k].reshape(40, 64) for k in range(3)))
    cam = V3(*(c_.reshape(18, 64) for c_ in d_cam))
    d = V3(*(torch.cat([a, b]) for a, b in zip(planted, cam)))
    return o.broadcast_to(d.x.shape), d


def _directions(route: str, scene, o: V3, d: V3) -> list:
    """Each level's input directions ``(d, alive)`` of one route's plain
    version, levels 1..DEPTH."""
    w = torch.ones(d.x.shape)
    tables = cuda_fold.fused_tables(scene)
    if route in ("whole", "chain"):
        trace = cuda_fold.trace_whole_reference if route == "whole" else cuda_level.trace_levels
        res = trace(tables, o, d, w, DEPTH, emit_res=True)[3]
        return [(V3(*r[3:6]), r[6] > 0) for r in res]
    seen = []

    def hit_fn(sc, oo, dd, active=None):
        if active is not None:
            seen.append((V3(*(c.clone() for c in dd)), active.clone()))
        return closest_hit_soa(sc, oo, dd, active=active)

    trace_soa(scene, o, d, depth=DEPTH, closest_hit_fn=hit_fn)
    return seen


def _worst(levels: list) -> float:
    """The largest ``| |d| - 1 |`` over the alive lanes of every level."""
    worst = 0.0
    for d, alive in levels:
        dev = ((d.x.double() ** 2 + d.y.double() ** 2 + d.z.double() ** 2).sqrt() - 1.0).abs()
        if bool(alive.any()):
            worst = max(worst, float(dev[alive].max()))
    return worst


def _old_bounce(hp: V3, hn: V3, d: V3):
    dn2 = 2.0 * (d.x * hn.x + d.y * hn.y + d.z * hn.z)
    return hp + hn * REFLECT_EPS, d - hn * dn2


@pytest.mark.parametrize("route", ROUTES)
def test_every_level_keeps_a_unit_direction(route, grid, rays):
    levels = _directions(route, grid, *rays)
    assert len(levels) == DEPTH
    assert all(bool(alive.any()) for _, alive in levels)
    assert _worst(levels) <= 1e-6


@pytest.mark.parametrize("route", ROUTES)
def test_the_old_bounce_leaves_unit(route, grid, rays, monkeypatch):
    """With ``d - 2 (d . n) n`` the same rays leave unit by far more."""
    monkeypatch.setattr(cuda_fold, "_bounce", _old_bounce)
    assert _worst(_directions(route, grid, *rays)) > 1e-4


def test_bounce_is_the_unit_reflect():
    """``_bounce`` against ``d^ - 2 (d^ . n^) n^`` in float64 on vectors off
    unit by up to 10%, and its next origin ``REFLECT_EPS`` along n^."""
    g = torch.Generator().manual_seed(5)
    d = V3(*torch.randn(3, 1000, generator=g))
    n = V3(*torch.randn(3, 1000, generator=g))
    n = n * (torch.rsqrt(n.norm2()) * (1.0 + 0.1 * torch.rand(1000, generator=g)))
    hp = V3(*torch.randn(3, 1000, generator=g))
    o_next, d_next = cuda_fold._bounce(hp, n, d)
    dh = torch.stack(list(d)).double()
    nh = torch.stack(list(n)).double()
    dh, nh = dh / dh.norm(dim=0), nh / nh.norm(dim=0)
    want = dh - 2.0 * (dh * nh).sum(dim=0) * nh
    torch.testing.assert_close(torch.stack(list(d_next)).double(), want, rtol=0, atol=1e-6)
    torch.testing.assert_close(torch.stack(list(o_next)).double(),
                               torch.stack(list(hp)).double() + REFLECT_EPS * nh,
                               rtol=0, atol=1e-6)


def test_bounce_gradient_is_blind_to_length():
    """Scaling the direction or the normal does not move the bounce, so the
    gradient of any function of it is orthogonal to each of them."""
    g = torch.Generator().manual_seed(6)
    d = V3(*(c.requires_grad_(True) for c in torch.randn(3, 500, generator=g)))
    n = V3(*(c.requires_grad_(True) for c in torch.randn(3, 500, generator=g)))
    hp = V3(*torch.randn(3, 500, generator=g))
    ct = torch.randn(6, 500, generator=g)
    o_next, d_next = cuda_fold._bounce(hp, n, d)
    out = sum((a * c).sum() for a, c in zip((*o_next, *d_next), ct))
    grads = torch.autograd.grad(out, [*d, *n])
    for grad, v in ((grads[:3], d), (grads[3:], n)):
        along = sum(a * b.detach() for a, b in zip(grad, v))
        scale = sum(a * a for a in grad).sqrt() * v.norm2().detach().sqrt()
        assert float((along.abs() / scale).max()) < 1e-5


def test_level_backward_is_its_own_span():
    """A hard fit step that takes the per-level route records one
    ``rt.level_bwd`` inside ``rt.backward`` a step, as the soft fit
    records ``rt.soft_bwd``."""
    scene = tscenes.grid_sphere_scene(GRID_PAST_CLASS, device="cpu")
    camera = tscenes.reference_demo_camera(device="cpu")
    assert not cuda_fold.in_fused_class(cuda_fold.fused_tables(scene), 2)
    init_fn, step_fn = make_fit_step(24, 12, depth=2, device="cpu")
    state = init_fn(scene)
    target = torch.zeros((12, 24, 3))
    profiler.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(2):
            state, loss = step_fn(state, scene, camera, target)
    reqs = profiler.snapshot()["requests"]
    assert [r["name"] for r in reqs] == ["rt.fit_step"] * 2
    for req in reqs:
        names = {s["id"]: s["name"] for s in req["spans"]}
        found = [names.get(s["parent"]) for s in req["spans"] if s["name"] == "rt.level_bwd"]
        assert found == ["rt.backward"]
    assert bool(torch.isfinite(loss))
