"""The port's per-level chain (its plain versions, which are what
``ray_stats``, ``trace_level`` and ``trace_levels`` run on CPU tensors)
against the JAX package's per-level chain, and against the port's own
whole-trace plain version.

Against JAX, both packages trace the same float32 rays through the same
scene: the JAX side through ``trace_levels_pallas`` (its Pallas kernels in
interpret mode on the CPU), the port through ``cuda_level.trace_levels``.
XLA contracts multiply-adds into FMAs where the port rounds every op, so the
bars are those of tests/test_torch_trace.py: indices on >= 99.9% of alive
lanes with every differing lane first differing at a grazing sphere hit; t
per level on the JAX chain's own input rays, to rtol 1e-5 plus the float32
cancellation slack of the full-form sphere recompute; rgb to 5e-4 on all but
0.1% of pixels, every pixel outside it on a path that drifted apart, with the
pixels whose JAX direction leaves unit by more than 1e-5 set aside (the
port's bounce is the upstream's unit reflect, the JAX chain's is not). The
JAX chain gates a listed chunk for its whole (32 or 64, 128) tile and the
port per lane; both are exact for unit directions.

The stats and shortlists are compared at the JAX kernel's own tile, (32,
128): boxes to rtol 1e-6 and atol 1e-5 (XLA's FMA in the segment ends),
centroids to rtol 1e-5 (summation order), list lengths, accepted sets,
alive flags and reach bits exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracer_tpu.core.v3 import V3 as JV3
from raytracer_tpu.models import scenes as jscenes
from raytracer_tpu.ops import pallas_fold as pf
from raytracer_tpu.ops.trace import raygen_tile as j_raygen_tile
from raytracer_tpu.oracle.numpy_ref import scene_to_numpy
from raytracer_tpu_torch.core.types import Scene
from raytracer_tpu_torch.core.v3 import V3
from raytracer_tpu_torch.models import scenes as tscenes
from raytracer_tpu_torch.ops import cuda_fold, cuda_level
from raytracer_tpu_torch.ops.trace import MISS_T, raygen_tile
from test_torch_trace import bent_lanes

torch.set_num_threads(1)

W, H = 128, 64
EPS32 = 2.0 ** -24


def _np(a):
    return np.array(a)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _grid80_boxes():
    """grid-80 (5 chunks of 16) with the mixed scene's two boxes."""
    return jscenes.grid_sphere_scene(80).replace(boxes=jscenes.mixed_primitive_scene().boxes)


def _no_spheres():
    """The mixed scene without its spheres: walls and boxes only."""
    m = tscenes.mixed_primitive_scene(device="cpu")
    sp = m.spheres
    mat = sp.material
    return m.replace(spheres=sp.replace(
        center=sp.center[:0], radius=sp.radius[:0],
        material=mat.replace(**{f: getattr(mat, f)[:0] for f in (
            "color", "ambient", "metallic", "diffuse", "specular", "specular_exponent")}),
    ))


def _port_rays(w, h):
    o, d = raygen_tile(tscenes.reference_demo_camera(device="cpu"), w, h)
    return o.broadcast_to(d.x.shape), d.broadcast_to(d.x.shape), torch.ones(d.x.shape)


def _one_level(tables, ray, w, is_last):
    """One level of the port's chain from these rays: stats, phase A, the
    level. Returns (t, index)."""
    o, d = V3(*ray[:3]), V3(*ray[3:])
    sl = (cuda_level.phase_a(cuda_level.ray_stats_reference(tables, o, d, w), tables)
          if cuda_level.uses_shortlists(tables) else None)
    zero = torch.zeros_like(w)
    t_k, i_k, *_ = cuda_level.trace_level_reference(
        tables, sl, o, d, w, V3(zero, zero, zero), is_last
    )
    return t_k, i_k


@pytest.fixture(scope="module")
def chain():
    """The JAX per-level chain with residuals on grid-80 with boxes at depth
    2 (the expensive part: re-tiled bounce shortlists in interpret mode),
    and the port's chain on the same inputs, whole and level by level."""
    depth = 2
    jscene = _grid80_boxes()
    o, d = j_raygen_tile(jscenes.reference_demo_camera(), W, H)
    o = JV3(*(jnp.broadcast_to(c, d.x.shape) for c in o))
    acc, ts, idxs, rays, ws, _ = pf.trace_levels_pallas(
        jscene, o, d, depth=depth, with_residuals=True
    )
    sn = scene_to_numpy(jscene, np.float32)
    tables = cuda_fold.fused_tables(Scene.from_numpy(sn, device="cpu"))
    rgb, t_p, i_p = cuda_level.trace_levels(
        tables, V3(*(_t(c) for c in o)), V3(*(_t(c) for c in d)), torch.ones((H, W)), depth
    )
    fed = [_one_level(tables, [_t(c) for c in ray], _t(w), k == depth)
           for k, (ray, w) in enumerate(zip(rays, ws))]
    return dict(
        sn=sn, depth=depth, tables=tables,
        j_rgb=np.stack([_np(c) for c in acc]), j_t=np.stack([_np(t) for t in ts]),
        j_i=np.stack([_np(i) for i in idxs]),
        j_rays=[np.stack([_np(c) for c in r]).astype(np.float64) for r in rays],
        j_alive=np.stack([_np(w) > 0 for w in ws]),
        p_rgb=torch.stack(list(rgb)).numpy(), p_t=t_p.numpy(), p_i=i_p.numpy(),
        fed_t=np.stack([f[0].numpy() for f in fed]),
        fed_i=np.stack([f[1].numpy() for f in fed]),
    )


def _is_grazing(sn, rays, y, x, cands):
    n_s = len(sn["sph_radius"])
    for i in cands:
        if 0 <= i < n_s:
            c = sn["sph_center"].astype(np.float64)[i]
            r2 = float(sn["sph_radius"][i]) ** 2
            oc = rays[:3, y, x] - c
            b = float(np.dot(rays[3:, y, x], oc))
            if abs(b * b - (float(np.dot(oc, oc)) - r2)) < 1e-2 * r2:
                return True
    return False


def test_chain_indices_match_jax(chain):
    r = chain
    alive, ji, pi = r["j_alive"], r["j_i"], r["p_i"]
    assert ji.shape == pi.shape == (r["depth"] + 1, H, W)
    assert (pi >= r["tables"].counts["n_s"] + 1).any(), "the boxes are hit"
    diff = alive & (ji != pi)
    assert diff.sum() <= 1e-3 * alive.sum(), f"{diff.sum()} of {alive.sum()} lanes differ"
    first = np.argmax(diff, axis=0)
    for y, x in zip(*np.nonzero(diff.any(axis=0))):
        k = first[y, x]
        assert _is_grazing(r["sn"], r["j_rays"][k], y, x, (ji[k, y, x], pi[k, y, x]))
    agree = np.cumprod(~alive | (ji == pi), axis=0).astype(bool)
    dead = ~alive & agree
    assert (pi[dead] == -1).all() and (r["p_t"][dead] == np.float32(MISS_T)).all()


def test_chain_t_matches_jax_per_level(chain):
    r = chain
    sn, n_s = r["sn"], len(r["sn"]["sph_radius"])
    assert (r["fed_i"] == r["j_i"])[r["j_alive"]].mean() >= 0.999
    for k in range(r["depth"] + 1):
        m = r["j_alive"][k] & (r["fed_i"][k] == r["j_i"][k])
        jt, pt, idx = r["j_t"][k][m], r["fed_t"][k][m], r["j_i"][k][m]
        rays = r["j_rays"][k][:, m]
        slack = np.zeros_like(jt, dtype=np.float64)
        sph = (idx >= 0) & (idx < n_s)
        if sph.any():
            c = np.moveaxis(sn["sph_center"].astype(np.float64)[idx[sph]], -1, 0)
            oc = rays[:3, sph] - c
            b = np.sum(rays[3:, sph] * oc, axis=0)
            disc = b * b - (np.sum(oc * oc, axis=0) - sn["sph_radius"].astype(np.float64)[idx[sph]] ** 2)
            slack[sph] = 4 * EPS32 * 4 * b * b / np.sqrt(np.maximum(4 * disc, 1e-30)) / np.abs(jt[sph])
        rel = np.abs(pt.astype(np.float64) - jt) / np.abs(jt)
        assert not (rel > 1e-5 + slack).any(), f"level {k}: worst rel {rel.max():.3g}"


def test_chain_rgb_matches_jax(chain):
    """The chain's rgb against the JAX chain's, as test_torch_trace.py holds
    the whole trace's: lanes whose JAX direction leaves unit by more than
    1e-5 at some level take another bounce there by design (``bent_lanes``)."""
    r = chain
    jt, pt = r["j_t"].astype(np.float64), r["p_t"]
    drift = r["j_alive"] & ((r["j_i"] != r["p_i"]) | (np.abs(pt - jt) > 1e-5 * np.abs(jt)))
    off = ~np.isclose(r["p_rgb"], r["j_rgb"], rtol=5e-4, atol=5e-4).all(axis=0)
    off &= ~bent_lanes(r)
    assert off.mean() <= 1e-3, f"{off.sum()} pixels outside 5e-4"
    assert not (off & ~drift.any(axis=0)).any()


@pytest.fixture(scope="module")
def stats_pair():
    """JAX's stats kernel (interpret mode) and phase A on grid-130 rays at
    its (32, 128) tile, with a seeded alive mask, and the port's plain
    stats and phase A on the same inputs."""
    sl_r, h, w = 32, 128, 128
    jscene = jscenes.grid_sphere_scene(130)
    o, d = j_raygen_tile(jscenes.reference_demo_camera(), w, h)
    rays = tuple(jnp.broadcast_to(c, (h, w)) for c in (*o, *d))
    act = np.random.default_rng(3).random((h, w)) > 0.2
    unroll = pf._resolve_unroll(130)
    n_c = -(-130 // unroll)
    with pf._use_unroll(130):
        c_lo, c_hi, gtables, gr, slab = pf._chunk_culling_tables(jscene, n_c)
        s_all = pf._ray_stats(
            slab, rays, jnp.asarray(act, jnp.float32), gtables[:5] + gtables[10:16],
            sl_r=sl_r, n_chunks=n_c, interpret=True, cfg=pf._cfg_key(),
        )
        j_stats = pf._stats_to_phase_a(s_all)
        j_reach = pf._stats_to_chunk_reach(s_all, n_c)
        j_list, j_counts = pf._phase_a_from_stats(c_lo, c_hi, gtables, gr, j_stats, n_c,
                                                  chunk_reach=j_reach)
    tables = cuda_fold.fused_tables(Scene.from_numpy(scene_to_numpy(jscene, np.float32),
                                                     device="cpu"))
    p_stats = cuda_level.ray_stats_reference(
        tables, V3(*(_t(c) for c in rays[:3])), V3(*(_t(c) for c in rays[3:])),
        torch.from_numpy(act.astype(np.float32)), (sl_r, 128),
    )
    p_list, p_counts = cuda_level.phase_a(p_stats, tables)
    return dict(
        n_c=n_c, tables=tables, p_stats=p_stats.numpy(),
        p_list=p_list.numpy(), p_counts=p_counts.numpy(),
        j_stats=[np.asarray(x).reshape(-1) for x in j_stats],
        j_reach=np.asarray(j_reach).reshape(-1, n_c),
        j_list=np.asarray(j_list).reshape(-1, n_c), j_counts=np.asarray(j_counts),
    )


def test_stats_match_jax(stats_pair):
    r = stats_pair
    s, j = r["p_stats"], r["j_stats"]
    assert s.shape == (4, cuda_level.NSTAT + r["n_c"])
    pad = cuda_fold._AABB_PAD
    for k, col in enumerate((0, 3, 1, 4, 2, 5)):  # JAX: x lo, x hi, y lo, ...
        want = j[k] + (pad if col < 3 else -pad)
        np.testing.assert_allclose(s[:, col], want, rtol=1e-6, atol=1e-5)
    cnt = np.maximum(s[:, 9], 1.0)
    for k in range(3):
        np.testing.assert_allclose(s[:, 6 + k] / cnt, j[6 + k], rtol=1e-5)
    np.testing.assert_array_equal(s[:, 10] > 0, j[9])
    np.testing.assert_array_equal(s[:, cuda_level.NSTAT:] > 0, r["j_reach"])
    assert s[:, 9].sum() > 0 and r["j_reach"].any() and not r["j_reach"].all()


def test_shortlists_match_jax(stats_pair):
    r = stats_pair
    np.testing.assert_array_equal(r["p_counts"], r["j_counts"])
    for t, n in enumerate(r["p_counts"]):
        n = max(int(n), 0)
        assert set(r["p_list"][t, :n]) == set(r["j_list"][t, :n])
        assert sorted(r["p_list"][t]) == list(range(r["n_c"]))
    # The order: accepted chunks near to far by the port's own keys, stable.
    tables, s = r["tables"], torch.from_numpy(r["p_stats"])
    cen = s[:, 6:9] / s[:, 9:10].clamp_min(1.0)
    g = tables.cols["c_g"]
    key = torch.sqrt(sum((cen[:, k:k + 1] - g[k]) ** 2 for k in range(3))) - tables.cols["gr"]
    for t, n in enumerate(r["p_counts"]):
        lst = torch.from_numpy(r["p_list"][t, :max(int(n), 0)]).long()
        kk = key[t, lst]
        assert (kk[1:] > kk[:-1]).logical_or((kk[1:] == kk[:-1]) & (lst[1:] > lst[:-1])).all()


@pytest.mark.parametrize(
    "make, depth, w, h",
    [(lambda: tscenes.grid_sphere_scene(64, device="cpu"), 3, 96, 48),
     (lambda: tscenes.grid_sphere_scene(80, device="cpu"), 2, 77, 35),
     (lambda: tscenes.reference_demo_scene(device="cpu"), 12, 64, 64),
     (lambda: tscenes.mixed_primitive_scene(device="cpu"), 2, 40, 24),
     (_no_spheres, 11, 40, 24)],
    ids=["grid64_d3", "grid80_d2_ragged", "demo_d12_identity", "mixed_d2", "no_spheres_d11"],
)
def test_chain_equals_whole_reference(make, depth, w, h):
    """The plain chain (shortlists where the scene has >= 3 chunks,
    identity lists below, no sphere fold without spheres) gives exactly the
    whole-trace plain version's outputs, residual planes included."""
    tables = cuda_fold.fused_tables(make())
    o, d, ones = _port_rays(w, h)
    want = cuda_fold.trace_whole_reference(tables, o, d, ones, depth, emit_res=True)
    got = cuda_level.trace_levels(tables, o, d, ones, depth, emit_res=True)
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)
