"""The port's soft renderer forward on the CPU (the soft kernels' plain
versions) against the JAX package: the per-primitive formulas, the tables
and gates, one plain level against the JAX kernel's level functions called
outside a kernel, and the whole ``trace_soft`` / ``render_soft`` against the
JAX package's XLA path.

Inputs are made with numpy from a fixed seed and the same scene dict
(``scene_to_numpy``) goes to both packages. The tolerance of the whole trace
is the JAX package's own between its kernel and its XLA path, atol = rtol =
2e-4 (tests/test_pallas_soft.py): the per-level form the port computes is
algebraically equal to the XLA path's recursion and differs by float32
reassociation. Each JAX reference is built once per module.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracer_tpu.core.v3 import V3 as JV3
from raytracer_tpu.diff import soft as jsoft
from raytracer_tpu.models import scenes as jscenes
from raytracer_tpu.ops import pallas_soft as ps
from raytracer_tpu.oracle.numpy_ref import scene_to_numpy
from raytracer_tpu_torch import render, render_soft
from raytracer_tpu_torch.core.types import Scene
from raytracer_tpu_torch.core.v3 import V3
from raytracer_tpu_torch.diff import soft as tsoft
from raytracer_tpu_torch.models import scenes as tscenes
from raytracer_tpu_torch.ops import cuda_soft
from raytracer_tpu_torch.ops.trace import raygen_tile

torch.set_num_threads(1)

W, H = 64, 32
TAU, TAU_Z = 0.02, 0.05
SCENES = {
    "grid16": lambda: jscenes.grid_sphere_scene(16, distance=4.0),  # 2 chunks: box gates
    "grid4": lambda: jscenes.grid_sphere_scene(4, distance=4.0),  # 1 chunk: sphere gate
    "mixed": jscenes.mixed_primitive_scene,  # spheres, walls, boxes, a sun
}


def both(name):
    """(JAX scene, port scene) from the same numpy dict."""
    js = SCENES[name]()
    return js, Scene.from_numpy(scene_to_numpy(js), device="cpu")


def camera_rays(w=W, h=H):
    """The demo camera's rays in both packages (port, JAX): the same float32
    values (the port's raygen equals the JAX package's to the last bit on
    these frames, tests/test_torch_trace.py)."""
    o, d = raygen_tile(tscenes.reference_demo_camera(device="cpu"), w, h)
    o = o.broadcast_to(d.x.shape)
    jo = JV3(*(jnp.asarray(c.numpy()) for c in o))
    jd = JV3(*(jnp.asarray(c.numpy()) for c in d))
    return (o, d), (jo, jd)


def random_rays(n, seed):
    """Rays from around the camera in random unit directions, roughly toward
    the scenes (+x), as numpy float32."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.5, 0.5, (3, n)).astype(np.float32)
    d = rng.standard_normal((3, n)).astype(np.float32)
    d[0] = np.abs(d[0]) * 2.0
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return o, d.astype(np.float32)


def assert_close(got, want, rtol, atol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


def test_formulas_match_jax():
    """Each primitive's coverage, soft t, hit point and normal, and the
    shaded colour, against the JAX package's formulas on random rays: one
    sphere, wall and box of the mixed scene, its point light and sun."""
    js, ts = both("mixed")
    tj = ps._soft_param_arrays(js, TAU, TAU_Z, ps._n_s_pad(js))
    tt = cuda_soft.soft_tables(ts, TAU, TAU_Z).arrays()
    o, d = random_rays(512, 0)
    to, td = V3(*map(torch.from_numpy, o)), V3(*map(torch.from_numpy, d))
    jo, jd = JV3(*map(jnp.asarray, o)), JV3(*map(jnp.asarray, d))
    pt_t, sun_t = cuda_soft._lights_of(tt, cuda_soft._counts(ts))
    pt_j, sun_j = ps._lights_of(ps._tbls_from(lambda k, i: tj[k][i],
                                              {k: v.shape[0] for k, v in tj.items()}),
                                ps._counts(js, ps._n_s_pad(js)))
    kinds = (
        ("s_", cuda_soft.SPH_KEYS[:4], tsoft._sphere_alpha_t_scalar, jsoft._sphere_alpha_t_scalar),
        ("w_", cuda_soft.WALL_GEO_KEYS, tsoft._wall_alpha_t_scalar, jsoft._wall_alpha_t_scalar),
        ("b_", cuda_soft.BOX_GEO_KEYS, tsoft._box_alpha_t_scalar, jsoft._box_alpha_t_scalar),
    )
    for prefix, keys, tf, jf in kinds:
        got = tf({k: tt[prefix + k][0] for k in keys}, to, td, torch.tensor(TAU))
        want = jf({k: tj[prefix + k][0] for k in keys}, jo, jd, TAU)
        alpha = np.asarray(want[0])
        assert (alpha > 0.5).any() and (alpha == 0.0).any(), prefix  # hits and exact misses
        assert_close(got[0], want[0], 1e-5, 1e-6, prefix + "alpha")
        assert_close(got[1], want[1], 1e-5, 1e-5, prefix + "t")
        for a, b in zip((*got[2], *got[3]), (*want[2], *want[3])):
            assert_close(a, b, 1e-5, 1e-5, prefix + "point/normal")
        mat = [tt[prefix + k][0] for k in cuda_soft.MAT_KEYS]
        jmat = [tj[prefix + k][0] for k in cuda_soft.MAT_KEYS]
        col = tsoft._shade_point_scalar(got[2], got[3], V3(-td.x, -td.y, -td.z), V3(*mat[:3]),
                                        *mat[3:7], pt_t, sun_t)
        jcol = jsoft._shade_point_scalar(want[2], want[3], -jd, JV3(*jmat[:3]), *jmat[3:7],
                                         pt_j, sun_j)
        for a, b in zip(col, jcol):
            assert_close(a, b, 1e-4, 1e-5, prefix + "colour")


@pytest.mark.parametrize("name", ["mixed", "grid16", "empty"])
def test_tables_match_jax(name, monkeypatch):
    """``soft_tables`` against ``_soft_param_arrays`` (every key, its size
    and values: the sphere padding, the wall basis, the unit sun, the sky,
    tau and tau_z) and ``soft_gate_tables`` against ``_soft_gate_arrays``
    at the port's coverage margin (``GATE_SIG_MARGIN``, twice the JAX
    package's: see ``test_chunk_gates_and_underflow``), with the gate
    geometry of ``_soft_gate_kind``; a scene without primitives keeps one
    never-hit pad chunk."""
    monkeypatch.setattr(ps, "_GATE_SIG_MARGIN", cuda_soft.GATE_SIG_MARGIN)
    if name == "empty":
        from raytracer_tpu.core.types import Scene as JScene

        js = JScene.create()
        ts = Scene.from_numpy(scene_to_numpy(js), device="cpu")
    else:
        js, ts = both(name)
    n_pad = ps._n_s_pad(js)
    want = ps._soft_param_arrays(js, TAU, TAU_Z, n_pad)
    tables = cuda_soft.soft_tables(ts, TAU, TAU_Z)
    got = tables.arrays()
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert_close(got[k], want[k], 1e-6, 1e-7, k)
    assert tables.counts["n_s_pad"] == n_pad
    gates = cuda_soft.soft_gate_tables(ts, TAU)
    for j, g in enumerate(ps._soft_gate_arrays(js, TAU, n_pad)):
        assert_close(gates[j], g, 1e-6, 1e-6, cuda_soft.GATE_KEYS[j])
    kind = ps._soft_gate_kind(n_pad // ps._SOFT_CHUNK)
    assert tables.counts["gate"] == (cuda_soft.GATE_AABB if kind == "aabb" else cuda_soft.GATE_SPHERE)


def test_chunk_gates_and_underflow():
    """The kernels' per-lane gate against ``_chunk_reachable`` (on live
    lanes, with the same gate tables) on random rays, both gate geometries;
    and the underflow canary: every contribution of a lane the gate rejects
    is exactly 0 in the plain formulas, value and gradient, as is the
    sigmoid at the margin. (At the JAX package's coverage margin of 128,
    this canary finds grid-4 lanes outside the gate whose contribution is a
    denormal, 4.6e-42: the port's margin is 256.)"""
    for name in ("grid16", "grid4"):  # box gates (2 chunks), the sphere gate (1)
        js, ts = both(name)
        n_pad = ps._n_s_pad(js)
        tables = cuda_soft.soft_tables(ts, TAU, TAU_Z)
        tbl, counts = tables.arrays(), tables.counts
        gates = cuda_soft.soft_gate_tables(ts, TAU)
        jgate = {k: jnp.asarray(gates[j].numpy()) for j, k in enumerate(ps._GATE_KEYS)}
        o, d = random_rays(2048, 1)
        to, td = V3(*map(torch.from_numpy, o)), V3(*map(torch.from_numpy, d))
        rays6 = tuple(jnp.asarray(x) for x in (*o, *d))
        ones = jnp.ones(o.shape[1], jnp.float32)
        geom = ps._tile_geom(rays6, ones)
        rejected = 0
        for c in range(counts["n_chunks"]):
            reach = cuda_soft.chunk_reachable(gates, counts["gate"], c, to, td, TAU)
            want = ps._chunk_reachable(jgate, c, rays6, geom, jnp.float32(TAU), n_pad // 8)
            np.testing.assert_array_equal(reach.numpy(), np.asarray(want))
            out = ~reach
            rejected += int(out.sum())
            p = {k: v.clone().requires_grad_(True) for k, v in cuda_soft._chunk(tbl, c, 1).items()}
            contrib = cuda_soft._sphere_contrib(cuda_soft._lights_of(tbl, counts), tbl["z_tau"][0],
                                                tbl["z_tau_z"][0], p, to, td,
                                                torch.full_like(td.x, 3.0), False)
            for x in contrib:
                assert float(x.detach()[:, out].abs().max()) == 0.0
            grads = torch.autograd.grad(sum(x[:, out].sum() for x in contrib), list(p.values()))
            assert all(float(g.abs().max()) == 0.0 for g in grads)
            assert bool(reach.any())
        assert rejected > 0
    for x in (-cuda_soft.GATE_SIG_MARGIN / 2, -cuda_soft.GATE_T_MARGIN):
        v = torch.tensor(x, requires_grad=True)
        y = tsoft._sigmoid(v)
        (g,) = torch.autograd.grad(y, v)
        assert y.item() == 0.0 and g.item() == 0.0
    assert float(tsoft._sigmoid(torch.tensor(-88.0))) > 0.0  # a denormal above -88.72


@pytest.fixture(scope="module")
def jax_levels():
    """The JAX kernel's level functions (``_soft_t_ref``,
    ``_soft_stream_sums``, ``_soft_post``) called outside a kernel, jitted
    once per (scene, last level), without the chunk gates (the plain level
    runs every chunk)."""
    cache = {}

    def get(name, is_last):
        if (name, is_last) in cache:
            return cache[(name, is_last)]
        js = SCENES[name]()
        n_pad = ps._n_s_pad(js)
        arrs = ps._soft_param_arrays(js, jnp.float32(TAU), jnp.float32(TAU_Z), n_pad)
        sizes = {k: int(v.shape[0]) for k, v in arrs.items()}
        cnt = ps._counts(js, n_pad)
        gate = dict(zip(ps._GATE_KEYS, ps._soft_gate_arrays(js, TAU, n_pad)))

        @jax.jit
        def level(rays6, w):
            tbls = ps._tbls_from(lambda k, i: arrs[k][i], sizes)
            sread = lambda k, i: arrs["s_" + k][i]  # noqa: E731
            geom = ps._tile_geom(rays6, w)
            t_ref = ps._soft_t_ref(tbls, sread, gate, rays6, geom, cnt)
            carry = ps._soft_stream_sums(tbls, sread, gate, rays6, geom, w, t_ref, cnt=cnt,
                                         is_last=is_last)
            return t_ref, carry, ps._soft_post(tbls, carry, rays6, w, cnt=cnt, is_last=is_last)

        gated = ps._SOFT_TUBE_GATE
        ps._SOFT_TUBE_GATE = False  # read at trace time
        try:
            cache[(name, is_last)] = jax.jit(level).lower(
                tuple(jnp.zeros((H, W), jnp.float32) for _ in range(6)),
                jnp.zeros((H, W), jnp.float32)).compile()
        finally:
            ps._SOFT_TUBE_GATE = gated
        return cache[(name, is_last)]

    return get


@pytest.mark.parametrize("name,levels", [("grid16", (0, 1)), ("grid4", (1,)), ("mixed", (0,))])
def test_plain_level_matches_jax(jax_levels, name, levels):
    """``soft_level_reference`` (t_ref, the carry, the accumulator, the
    next rays and throughput) against the JAX kernel's level functions on
    the same input rays: level 0 from the camera, level 1 from the port's
    own level-0 outputs (with their dead lanes)."""
    js, ts = both(name)
    tables = cuda_soft.soft_tables(ts, TAU, TAU_Z)
    (o, d), _ = camera_rays()
    w = torch.ones_like(d.x)
    acc = V3(*(torch.zeros_like(w) for _ in range(3)))
    for k in range(max(levels) + 1):
        last = k == 1
        acc_n, w_n, o_n, d_n, res = cuda_soft.soft_level_reference(tables, o, d, w, acc, last, True)
        if k in levels:
            rays6 = tuple(jnp.asarray(c.numpy()) for c in (*o, *d))
            t_ref, carry, outs = jax_levels(name, last)(rays6, jnp.asarray(w.numpy()))
            assert_close(res[0], t_ref, 1e-5, 1e-5, "t_ref")
            for j, (a, b) in enumerate(zip(res[1:], carry)):
                assert_close(a, b, 1e-4, 1e-4 * max(float(np.abs(b).max()), 1.0), f"carry {j}")
            got = (*(acc_n[j] - acc[j] for j in range(3)), w_n, *o_n, *d_n)
            for j, (a, b) in enumerate(zip(got, outs)):
                assert_close(a, b, 2e-4, 2e-4, f"output {j}")
        if k == 0:
            assert bool((w_n == 0).any()) and bool((w_n > 0).any())
        acc, w, o, d = acc_n, w_n, o_n, d_n


def test_trace_soft_matches_jax():
    """``trace_soft`` against the JAX package's on a ragged frame (37x23)
    whose lower rows look away from the scene (all-miss lanes), grid-4 at
    depth 1, to atol = rtol = 2e-4 (tests/test_torch_soft_grad.py holds the
    mixed scene's image to the same bar)."""
    (o, d), (jo, jd) = camera_rays(37, 23)
    flip = torch.arange(23)[:, None] >= 15
    d = V3(*(torch.where(flip, -c, c) for c in d))
    jd = JV3(*(jnp.asarray(c.numpy()) for c in d))
    js, ts = both("grid4")
    with torch.no_grad():
        got = tsoft.trace_soft(ts, o, d, tau=TAU, tau_z=TAU_Z, depth=1).stacked()
    want = np.asarray(jsoft.trace_soft(js, jo, jd, tau=TAU, tau_z=TAU_Z, depth=1).stacked())
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-4)
    assert bool(torch.isfinite(got).all())
    sky = got[15:]  # the all-miss rows see the sky (and the ground) only
    assert float(sky.min()) >= 0.0 and float(np.abs(want[15:]).max()) > 0.0


def test_render_soft_limits():
    """A scene without primitives renders the sky, exactly as the hard
    ``render`` does; as tau -> 0 the soft render converges to the hard one
    away from silhouettes (the JAX package's tests/test_soft.py bars)."""
    cam = tscenes.reference_demo_camera(device="cpu")
    empty = Scene.create()
    soft = render_soft(empty, cam, W, H, tonemap=False, device="cpu")
    hard = render(empty, cam, W, H, depth=0, tonemap=False, device="cpu")
    np.testing.assert_allclose(soft.numpy(), hard.numpy(), atol=1e-6)
    scene = tscenes.reference_demo_scene(device="cpu")
    hard = render(scene, cam, W, H, depth=0, tonemap=False, device="cpu").numpy()
    soft = render_soft(scene, cam, W, H, tau=0.001, tau_z=0.02, tonemap=False,
                       device="cpu").numpy()
    assert np.isfinite(soft).all()
    assert (np.abs(soft - hard).max(axis=-1) < 3e-2).mean() > 0.99
