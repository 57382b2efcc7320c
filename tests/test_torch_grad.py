"""The port's whole-trace backward (its plain version, which is what
``trace_whole_bwd`` runs on CPU tensors) against the JAX package's
whole-trace backward kernel, and the autograd wiring around it. CPU only.

Against the JAX kernel, both sides get the very same forward residuals (the
JAX kernel's per-level input rays, throughput, t and index) and the same
seeded image cotangent, so only the backward arithmetic is compared. The JAX
kernel runs in interpret mode, compiled by XLA, which contracts
multiply-adds into FMAs where the port rounds every op. Two kinds of lanes
magnify that difference into the gradient, and their image cotangent is set
to 0 on both sides:

* grazing sphere hits (|disc| < 1e-2 r^2 in float64 at some level), where
  dt/d(geometry) grows like 1/sqrt(disc);
* lanes where the port's replay of the hit record gives another t than the
  JAX kernel saved (relative difference > 1e-6 at some level; the test
  allows at most 10% of the lanes to be set aside): the two differentiate
  at different points;
* lanes where the replayed record's normal leaves unit by more than 1e-3 at
  some level. The port bounces with the upstream's reflect, ``d^ - 2 (d^ .
  n^) n^`` with the direction and the normal made unit; the JAX kernel
  keeps ``d - 2 (d . n) n``, whose directions drift off unit after grazing
  hits, so its residuals there hold normals off unit (up to 2% on grid-130)
  and the two backwards differ by that much.

On the rest, every scene leaf agrees to 1e-3 of the leaf's largest entry
(the spheres' specular strength and exponent come closest to it: their
gradients carry the exponent-50 lobe's float32 rounding), and the ray
cotangents to rtol 1e-3 plus 1e-4 of the plane's largest entry
on all but 0.1% of the lanes. Two components differ by design and are
projected out of both sides first (``_tangential``): the port's bounce does
not change when a direction or a normal is scaled, the JAX kernel's does.
So the cotangent of each camera ray's direction is compared without its
component along that (unit) direction, and the walls' normal leaf without
its component along the normal. The spheres' leaves keep |d| and |n| at 1
in exact arithmetic whatever their values, so their gradients are the same
function on both sides and are compared whole.
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
from raytracer_tpu_torch.core.types import Scene
from raytracer_tpu_torch.core.v3 import V3
from raytracer_tpu_torch.models import scenes as tscenes
from raytracer_tpu_torch.ops import cuda_fold
from raytracer_tpu_torch.ops.trace import MISS_T, raygen_tile, trace_soa
from raytracer_tpu_torch.utils.profiler import launches

torch.set_num_threads(1)

W, H = 128, 64  # multiples of the JAX kernel's (64, 128) tile: no cropping

CASES = {
    "sprint3_d3": (jscenes.sprint3_scene, 3),
    "grid64_d2": (lambda: jscenes.grid_sphere_scene(64), 2),
}


def scene_leaves(scene: Scene) -> dict:
    """The port scene's tensor leaves under ``scene_to_numpy``'s keys."""
    def mat(p, m):
        return {
            p + "_color": m.color, p + "_ambient": m.ambient,
            p + "_metallic": m.metallic, p + "_diffuse": m.diffuse,
            p + "_specular": m.specular, p + "_exponent": m.specular_exponent,
        }

    s, w, b, li, sky = scene.spheres, scene.walls, scene.boxes, scene.lights, scene.sky
    return {
        "sph_center": s.center, "sph_radius": s.radius, **mat("sph", s.material),
        "wall_position": w.position, "wall_normal": w.normal,
        "wall_length": w.length, "wall_width": w.width, **mat("wall", w.material),
        "box_min": b.minimum, "box_max": b.maximum, **mat("box", b.material),
        "light_pos": li.point_position, "light_color": li.point_color,
        "sun_dir": li.sun_direction, "sun_color": li.sun_color,
        "ground": sky.ground_color, "horizon": sky.horizon_color,
        "zenith": sky.zenith_color, "sky_exp": sky.gradient_exponent,
    }


def leaf_grads(scene: Scene, ct_attrs, ct_ls) -> dict:
    """The table cotangents mapped to the scene's leaves through autograd of
    ``attribute_tables`` (numpy, keyed as ``scene_to_numpy``)."""
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in scene_leaves(scene).items()}
    attrs, ls = cuda_fold.attribute_tables(_with_leaves(scene, leaves))
    g = torch.autograd.grad((attrs, ls), list(leaves.values()), (ct_attrs, ct_ls), allow_unused=True)
    return {k: (np.zeros(v.shape, np.float32) if gk is None else gk.numpy())
            for (k, v), gk in zip(leaves.items(), g)}


def _with_leaves(s: Scene, t: dict) -> Scene:
    def mat(m, p):
        return m.replace(color=t[p + "_color"], ambient=t[p + "_ambient"],
                         metallic=t[p + "_metallic"], diffuse=t[p + "_diffuse"],
                         specular=t[p + "_specular"], specular_exponent=t[p + "_exponent"])

    return s.replace(
        spheres=s.spheres.replace(center=t["sph_center"], radius=t["sph_radius"],
                                  material=mat(s.spheres.material, "sph")),
        walls=s.walls.replace(position=t["wall_position"], normal=t["wall_normal"],
                              length=t["wall_length"], width=t["wall_width"],
                              material=mat(s.walls.material, "wall")),
        boxes=s.boxes.replace(minimum=t["box_min"], maximum=t["box_max"],
                              material=mat(s.boxes.material, "box")),
        lights=s.lights.replace(point_position=t["light_pos"], point_color=t["light_color"],
                                sun_direction=t["sun_dir"], sun_color=t["sun_color"]),
        sky=s.sky.replace(ground_color=t["ground"], horizon_color=t["horizon"],
                          zenith_color=t["zenith"], gradient_exponent=t["sky_exp"]),
    )


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _tangential(c: np.ndarray, n: np.ndarray, axis: int) -> np.ndarray:
    """``c`` less its component along ``n`` (made unit), the vectors laid
    along ``axis``, in float64."""
    c, n = c.astype(np.float64), n.astype(np.float64)
    n = n / np.linalg.norm(n, axis=axis, keepdims=True)
    return c - n * np.sum(c * n, axis=axis, keepdims=True)


def compared_leaf(sn, key, got, want):
    """A leaf's cotangents as compared: the walls' normal without its
    component along the normal (see the module docstring)."""
    if key == "wall_normal":
        return _tangential(got, sn[key], -1), _tangential(want, sn[key], -1)
    return got, want


def compared_rays(d0, got, want):
    """The six ray-plane cotangents of each side as compared: the
    direction's without its component along the camera ray ``d0`` (see the
    module docstring)."""
    return [[*side[:3], *_tangential(np.stack(side[3:]), d0, 0)] for side in (got, want)]


def _excluded_lanes(sn, tables, attrs, rays, ws, ts, idxs, depth) -> np.ndarray:
    """Lanes with a grazing sphere hit, whose replayed hit t differs from
    the JAX kernel's saved t, or whose replayed normal leaves unit by more
    than 1e-3, at some level (see the module docstring)."""
    n_s = len(sn["sph_radius"])
    out = np.zeros((H, W), bool)
    for k in range(depth + 1):
        r = np.stack([np.asarray(c) for c in rays[k]]).astype(np.float64)
        i, alive = np.asarray(idxs[k]), np.asarray(ws[k]) > 0
        ii = np.clip(i, 0, max(n_s - 1, 0))
        if n_s:
            oc = r[:3] - np.moveaxis(sn["sph_center"].astype(np.float64)[ii], -1, 0)
            b = np.sum(r[3:] * oc, axis=0)
            r2 = sn["sph_radius"].astype(np.float64)[ii] ** 2
            disc = b * b - (np.sum(oc * oc, axis=0) - r2)
            out |= alive & (i >= 0) & (i < n_s) & (np.abs(disc) < 1e-2 * r2)
        it, tt = _t(idxs[k]), _t(ts[k])
        hit = it >= 0
        acc = cuda_fold._gather(attrs.unbind(1), it, hit)
        t_rep, _, hn = cuda_fold._record_math(
            acc, tt, hit, *cuda_fold._kinds(it, hit, tables.counts),
            V3(*(_t(c) for c in rays[k][:3])), V3(*(_t(c) for c in rays[k][3:])),
        )
        off_unit = np.abs(np.sqrt(sum(c.double().numpy() ** 2 for c in hn)) - 1.0) > 1e-3
        out |= alive & hit.numpy() & (((t_rep - tt).abs() > 1e-6 * tt.abs()).numpy() | off_unit)
    return out


@pytest.fixture(scope="module")
def backward_pairs():
    """One JAX forward with residuals and one JAX backward per case (the
    expensive part), and the port's plain backward on the same inputs."""
    cache = {}

    def get(case):
        if case not in cache:
            make, depth = CASES[case]
            jscene = make()
            o, d = j_raygen_tile(jscenes.reference_demo_camera(), W, H)
            o = JV3(*(jnp.broadcast_to(c, d.x.shape) for c in o))
            _, ts, idxs, rays, ws, sls = trace_levels_pallas(
                jscene, o, d, depth=depth, with_residuals=True
            )
            sn = scene_to_numpy(jscene, np.float32)
            scene = Scene.from_numpy(sn, device="cpu")
            tables = cuda_fold.fused_tables(scene)
            attrs, ls = (a.detach() for a in cuda_fold.attribute_tables(scene))
            excluded = _excluded_lanes(sn, tables, attrs, rays, ws, ts, idxs, depth)
            ct = np.random.default_rng(7).normal(size=(3, H, W)).astype(np.float32)
            ct[:, excluded] = 0.0
            scene_ct, ct_o, ct_d = trace_levels_pallas_bwd(
                jscene, ts, idxs, rays, ws, sls, JV3(*(jnp.asarray(c) for c in ct)),
                depth=depth,
            )
            levels = cuda_fold.Residuals(
                V3(*(_t(c) for c in rays[0][:3])), V3(*(_t(c) for c in rays[0][3:])),
                _t(ws[0]), torch.stack([_t(t) for t in ts]),
                torch.stack([_t(i) for i in idxs]),
                torch.stack([torch.stack([_t(c) for c in (*rays[k], ws[k])])
                             for k in range(1, depth + 1)]),
            )
            p_o, p_d, _, p_attrs, p_ls = cuda_fold.trace_whole_bwd_reference(
                tables, attrs, ls, levels, V3(*(torch.from_numpy(c) for c in ct)), depth
            )
            cache[case] = dict(
                sn=sn, excluded=excluded,
                jax_leaves=scene_to_numpy(scene_ct, np.float32),
                port_leaves=leaf_grads(scene, p_attrs, p_ls),
                jax_rays=[np.asarray(c) for c in (*ct_o, *ct_d)],
                port_rays=[c.numpy() for c in (*p_o, *p_d)],
                d0=np.stack([np.asarray(c) for c in rays[0][3:]]),
            )
        return cache[case]

    return get


@pytest.mark.parametrize("case", list(CASES))
def test_scene_cotangents_match_jax_kernel(backward_pairs, case):
    r = backward_pairs(case)
    assert r["excluded"].mean() <= 0.1
    metallic_ok = {p: r["sn"][p + "_metallic"] > 0 for p in ("sph", "wall", "box")}
    for key, want in r["jax_leaves"].items():
        got = r["port_leaves"][key]
        assert got.shape == want.shape, key
        if not want.size:
            continue
        if key.endswith("_metallic"):
            keep = metallic_ok[key.split("_")[0]]
            got, want = got[keep], want[keep]
        assert np.isfinite(got).all(), key
        got, want = compared_leaf(r["sn"], key, got, want)
        scale = float(np.abs(want).max()) if want.size else 0.0
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * scale + 1e-12, err_msg=key)


@pytest.mark.parametrize("case", list(CASES))
def test_ray_cotangents_match_jax_kernel(backward_pairs, case):
    r = backward_pairs(case)
    port, jax = compared_rays(r["d0"], r["port_rays"], r["jax_rays"])
    for name, got, want in zip(("o.x", "o.y", "o.z", "d.x", "d.y", "d.z"), port, jax):
        assert np.isfinite(got).all(), name
        off = ~np.isclose(got, want, rtol=1e-3, atol=1e-4 * np.abs(want).max())
        assert off.mean() <= 1e-3, f"{name}: {off.sum()} lanes off"


def _direct_trace(scene: Scene, o: V3, d: V3, depth: int) -> V3:
    """The trace differentiated by plain autograd: each level's fold at the
    current rays (selection only), then ``_level_math`` on the gathered
    attributes, with the dead lanes masked as the forward masks them. The
    gather reads a float64 copy of the table, so its scatter sums in
    float64 as the plain backward's does."""
    tables = cuda_fold.fused_tables(scene)
    counts = tables.counts
    attrs, ls = cuda_fold.attribute_tables(scene)
    cols = attrs.double().unbind(1)
    w = torch.ones_like(d.x)
    zero = torch.zeros_like(w)
    acc = V3(zero, zero, zero)
    for k in range(depth + 1):
        alive = w > 0.0
        with torch.no_grad():
            bt, bi = cuda_fold._fold(tables.cols, counts, V3(*(c.detach() for c in o)),
                                     V3(*(c.detach() for c in d)))
        hit = bt < MISS_T
        a = [c.float() for c in cuda_fold._gather(cols, bi, hit)]
        _, inc, w_next, o_next, d_next = cuda_fold._level_math(
            a, o, d, w, bt, hit, *cuda_fold._kinds(bi, hit, counts), ls, counts, k == depth
        )
        acc = acc + V3.where(alive, inc, V3(zero, zero, zero))
        w = torch.where(alive, w_next, w)
        o, d = V3.where(alive, o_next, o), V3.where(alive, d_next, d)
    return acc


@pytest.mark.parametrize(
    "make, depth",
    [(tscenes.sprint3_scene, 3), (tscenes.mixed_primitive_scene, 2)],
    ids=["sprint3_d3", "mixed_d2"],
)
def test_function_gradient_equals_direct_autograd(make, depth):
    """``trace_soa`` with leaves that require grad goes through the
    autograd Function (plain forward with residuals, plain backward); its
    gradient equals autograd straight through ``_level_math``."""
    scene = make(device="cpu")
    leaves = list(scene.tensors())
    for t in leaves:
        t.requires_grad_(True)
    o, d = raygen_tile(tscenes.reference_demo_camera(device="cpu"), 64, 48)
    o, d = o.broadcast_to(d.x.shape), d.broadcast_to(d.x.shape)
    d = V3(*(c.clone().requires_grad_(True) for c in d))
    ct = torch.from_numpy(np.random.default_rng(1).normal(size=(3, 48, 64)).astype(np.float32))
    before = launches("trace_whole_bwd")
    got_img = trace_soa(scene, o, d, depth=depth)
    assert got_img.x.grad_fn is not None
    want_img = _direct_trace(scene, o, d, depth)
    for a, b in zip(got_img, want_img):
        assert torch.equal(a, b)
    wrt = leaves + list(d)
    got = torch.autograd.grad(sum((a * c).sum() for a, c in zip(got_img, ct)), wrt, allow_unused=True)
    want = torch.autograd.grad(sum((a * c).sum() for a, c in zip(want_img, ct)), wrt, allow_unused=True)
    assert launches("trace_whole_bwd") == before
    n_nonzero = 0
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is None or not g.numel():
            continue
        assert torch.isfinite(g).all()
        n_nonzero += bool(w.abs().max() > 0)
        torch.testing.assert_close(g, w, rtol=0, atol=1e-6 * float(w.abs().max()))
    assert n_nonzero >= 20


def test_emit_res_planes_are_each_levels_inputs():
    """With ``emit_res`` the plain forward also returns level k's input rays
    and throughput for k >= 1, which stepping one level at a time gives;
    the other outputs do not change."""
    scene = tscenes.mixed_primitive_scene(device="cpu")
    tables = cuda_fold.fused_tables(scene)
    o, d = raygen_tile(tscenes.reference_demo_camera(device="cpu"), 48, 32)
    o, d = o.broadcast_to(d.x.shape), d.broadcast_to(d.x.shape)
    w = torch.ones(d.x.shape)
    rgb, t, i, res = cuda_fold.trace_whole(tables, o, d, w, 2, emit_res=True)
    rgb0, t0, i0 = cuda_fold.trace_whole(tables, o, d, w, 2)
    assert all(torch.equal(a, b) for a, b in zip(rgb, rgb0))
    assert torch.equal(t, t0) and torch.equal(i, i0)
    assert res.shape == (2, 7, 32, 48)
    levels = cuda_fold.Residuals(o, d, w, t, i, res)
    for k in range(2):
        lo, ld, lw = levels.level(k)
        alive = lw > 0
        _, _, _, w_n, o_n, d_n = cuda_fold._level(tables.cols, tables.counts, lo, ld, lw, False)
        want = [torch.where(alive, a, b) for a, b in zip((*o_n, *d_n, w_n), (*lo, *ld, lw))]
        for j in range(7):
            assert torch.equal(res[k, j], want[j])
    assert bool((res[:, 6] == 0).any()) and bool((res[:, 6] > 0).any())


def test_all_miss_gradients_finite():
    """Every lane misses the sphere (moved 1e4 away), and in the second
    scene every primitive: the gradient is finite (no 0 * inf from the
    guarded sqrt and divides) and exactly 0 for the unseen sphere."""
    cam = tscenes.reference_demo_camera(device="cpu")
    base = tscenes.reference_demo_scene(device="cpu")
    far = base.spheres.center + 1e4
    for scene in (base, base.replace(walls=base.walls.replace(position=base.walls.position + 1e4))):
        center = far.clone().requires_grad_(True)
        sky = scene.sky.zenith_color.clone().requires_grad_(True)
        sc = scene.replace(spheres=scene.spheres.replace(center=center),
                           sky=scene.sky.replace(zenith_color=sky))
        img = tscenes_render(sc, cam)
        gc, gs = torch.autograd.grad(torch.mean(img ** 2), (center, sky))
        assert torch.isfinite(gc).all() and torch.isfinite(gs).all()
        assert float(gc.abs().max()) == 0.0 and float(gs.abs().max()) > 0.0


def tscenes_render(scene, cam):
    from raytracer_tpu_torch import render

    return render(scene, cam, 64, 48, depth=2, tonemap=False, device="cpu")


def test_trace_whole_bwd_checks_inputs():
    scene = tscenes.sprint3_scene(device="cpu")
    tables = cuda_fold.fused_tables(scene)
    attrs, ls = (a.detach() for a in cuda_fold.attribute_tables(scene))
    assert attrs.shape == (3, 14) and ls.shape == (6 + 6 + 10,)
    ones = torch.ones((4, 8))
    o, d = V3(ones * 0, ones * 0, ones * 0), V3(ones, ones * 0, ones * 0)
    _, t, i, res = cuda_fold.trace_whole(tables, o, d, ones, 1, emit_res=True)
    levels = cuda_fold.Residuals(o, d, ones, t, i, res)
    ct = V3(ones, ones, ones)
    with pytest.raises(ValueError, match="int32"):
        cuda_fold.trace_whole_bwd(tables, attrs, ls, cuda_fold.Residuals(o, d, ones, t, i.long(), res), ct, 1)
    with pytest.raises(ValueError, match="shape"):
        cuda_fold.trace_whole_bwd(tables, attrs, ls, levels, ct, 2)
    with pytest.raises(ValueError, match="shape"):
        cuda_fold.trace_whole_bwd(tables, attrs[:2], ls, levels, ct, 1)
    ct_o, ct_d, ct_w, ct_attrs, ct_ls = cuda_fold.trace_whole_bwd(tables, attrs, ls, levels, ct, 1)
    assert ct_attrs.shape == attrs.shape and ct_ls.shape == ls.shape
    # The table values are the fused table's, column for column.
    cols = cuda_fold._attr_columns(tables.cols, tables.counts)
    assert torch.equal(torch.stack(cols, dim=1), attrs)
    assert torch.equal(cuda_fold._ls_vector(tables.cols), ls)


def test_tie_rules():
    """The derivative rules at ties, which the backward kernels follow too
    (csrc/trace_common.cuh's `wmax`/`wmin`): every max and min gives each
    side half of the cotangent at a tie, the box slabs' ``torch.maximum``
    and the clamps against a constant (``cuda_fold.max_c``) alike, as
    ``jax.grad`` of the JAX package's functions gives it (``jnp.maximum``;
    its clamps are written ``jnp.maximum(x, c)``)."""
    import jax

    from raytracer_tpu.diff.soft import _box_alpha_t_scalar
    from raytracer_tpu.ops.trace import _light_terms

    counts = {"n_s": 0, "n_w": 1, "n_b": 1, "n_pt": 0, "n_sun": 1}
    one = torch.ones(1)
    # A ray along (1, 1, 0) into the box [1, 2] x [1, 2] x [-1, 1]: the x and
    # y slabs tie at t = sqrt(2); z is parallel (srecip clamps, no gradient).
    s = float(np.sqrt(0.5))
    corners = (1.0, 1.0, -1.0, 2.0, 2.0, 1.0)
    geom = [torch.tensor([v], requires_grad=True) for v in corners]
    acc = geom + [one * 0.5] * 8
    o, d = V3(one * 0, one * 0, one * 0), V3(one * s, one * s, one * 0)
    hit = torch.tensor([True])
    no = torch.tensor([False])
    tt, _, _ = cuda_fold._record_math(acc, one, hit, no, no, hit, o, d)
    g = torch.autograd.grad(tt.sum(), geom)
    keys = ("mnx", "mny", "mnz", "mxx", "mxy", "mxz")
    jo, jd = JV3(*(jnp.float32(v) for v in (0, 0, 0))), JV3(*(jnp.float32(v) for v in (s, s, 0)))
    want = jax.grad(
        lambda p: _box_alpha_t_scalar(p, jo, jd, 0.02)[1]
    )({k: jnp.float32(v) for k, v in zip(keys, corners)})
    np.testing.assert_allclose([float(x) for x in g], [float(want[k]) for k in keys], rtol=1e-6)
    assert float(want["mnx"]) != 0.0  # the tie splits, it does not drop
    # A wall with normal +z hit straight down, lit by a sun along +x: the
    # diffuse lobe sits exactly at its clamp (l . n = 0); with no specular
    # strength, the sun direction's z cotangent is the lobe's slope at the
    # tie, half of it, as jax.grad of the JAX package's _light_terms gives.
    wall = [0.0, 0.0, 1.0, 0.0, 0.0, 0.0]  # normal, corner
    mats = [1.0, 1.0, 1.0, 0.0, 0.0, 1.0, 0.0, 1.0]  # rgb, amb, met, dif, spe, exp
    acc = [one * v for v in wall + mats]
    ls = torch.tensor([1.0, 0.0, 0.0, 1.0, 1.0, 1.0] + [0.5] * 9 + [0.25], requires_grad=True)
    o, d = V3(one * 0, one * 0, one), V3(one * 0, one * 0, -one)
    _, inc, _, _, _ = cuda_fold._level_math(
        acc, o, d, one, one, hit, no, hit, no, ls, counts, True
    )
    (g,) = torch.autograd.grad(inc.x.sum(), ls)
    f32 = jnp.float32
    want = jax.grad(lambda lz: _light_terms(
        JV3(f32(1.0), f32(0.0), lz), JV3(f32(0.0), f32(0.0), f32(1.0)),
        JV3(f32(0.0), f32(0.0), f32(1.0)), f32(1.0))[0])(f32(0.0))
    assert inc.x.item() == 0.0 and float(want) == 0.5
    assert g[2].item() == float(want)
    # The tone map's clamp of the luma, at a luma of exactly 0 (its two
    # products cancel): torch.maximum, as the JAX package's jnp.maximum.
    from raytracer_tpu.ops.tonemap import reinhard_tonemap as j_tonemap
    from raytracer_tpu_torch.ops.tonemap import reinhard_tonemap

    x = np.array([[0.7152, -0.2126, 0.0]], np.float32)
    rgb = torch.tensor(x, requires_grad=True)
    (g,) = torch.autograd.grad(reinhard_tonemap(rgb)[0, 0], rgb)
    want = jax.grad(lambda v: j_tonemap(v)[0, 0])(jnp.asarray(x))
    np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-6)
    assert float(want[0, 1]) != 0.0
