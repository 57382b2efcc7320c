"""The port's whole-trace plain version against the JAX whole-trace kernel.

Both packages trace the same float32 rays through the same scene: the JAX
side through ``trace_levels_pallas`` (its Pallas kernel in interpret mode on
the CPU), the port through ``trace_whole_reference``, which is what
``trace_whole`` runs on CPU tensors. The JAX kernel is compiled by XLA, which
contracts multiply-adds into FMAs; the port rounds every op separately (as
its CUDA kernel does, built with -fmad=false). The checks allow for exactly
that difference and no more:

* per-level hit indices agree on >= 99.9% of alive lanes, and every lane
  that differs first differs at a grazing sphere hit;
* t agrees to rtol 1e-5 plus 4 float32 ulps of the cancellation in the
  full-form sphere recompute of t (its discriminant is a difference of two
  terms near bq^2), on lanes whose indices agree. Each level is compared on
  the JAX kernel's own input rays of that level (its residuals), so the
  check sees that level's arithmetic; over a whole trace the FMA rounding
  of one level's hit point moves the next level's rays, and t there drifts
  by up to ~1e-3 at grazing bounces;
* rgb agrees to rtol = atol = 5e-4, the bar tests/test_pallas_fold.py sets
  between the same kernel and the jnp path, on all but 0.1% of pixels, and
  every pixel outside it has a path that drifted apart (another selection,
  or t off by more than 1e-5, at some level), as the grid's
  sphere-to-sphere bounces magnify one level's rounding into the next.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracer_tpu.core.v3 import V3 as JV3
from raytracer_tpu.models import scenes as jscenes
from raytracer_tpu.ops.pallas_fold import trace_levels_pallas
from raytracer_tpu.ops.trace import raygen_tile as j_raygen_tile
from raytracer_tpu.oracle.numpy_ref import scene_to_numpy
from raytracer_tpu_torch.core.types import Scene
from raytracer_tpu_torch.core.v3 import V3
from raytracer_tpu_torch.models import scenes as tscenes
from raytracer_tpu_torch.ops import cuda_fold
from raytracer_tpu_torch.ops.trace import MISS_T, trace_soa
from raytracer_tpu_torch.utils.profiler import launches

torch.set_num_threads(1)

W, H = 128, 64  # multiples of the JAX kernel's (64, 128) tile: no cropping
EPS32 = 2.0 ** -24

CASES = {
    "sprint3_d3": (jscenes.sprint3_scene, 3),
    "grid64_d2": (lambda: jscenes.grid_sphere_scene(64), 2),
    "mixed_d2": (jscenes.mixed_primitive_scene, 2),
    "demo_d10": (jscenes.reference_demo_scene, 10),
}


def _np(a):
    return np.array(a)


@pytest.fixture(scope="module")
def traced():
    """One JAX reference call per case (the expensive part), and the port's
    plain version on the same inputs."""
    cache = {}

    def get(case):
        if case not in cache:
            make, depth = CASES[case]
            jscene = make()
            o, d = j_raygen_tile(jscenes.reference_demo_camera(), W, H)
            o = JV3(*(jnp.broadcast_to(c, d.x.shape) for c in o))
            acc, ts, idxs, rays, ws, _ = trace_levels_pallas(
                jscene, o, d, depth=depth, with_residuals=True
            )
            sn = scene_to_numpy(jscene, np.float32)
            tables = cuda_fold.fused_tables(Scene.from_numpy(sn, device="cpu"))
            rgb, t_p, i_p = cuda_fold.trace_whole(
                tables,
                V3(*(torch.from_numpy(_np(c)) for c in o)),
                V3(*(torch.from_numpy(_np(c)) for c in d)),
                torch.ones((H, W)), depth,
            )
            # Each level again, from the JAX kernel's inputs of that level.
            fed = [
                cuda_fold.trace_whole(
                    tables, V3(*(torch.from_numpy(_np(c)) for c in ray[:3])),
                    V3(*(torch.from_numpy(_np(c)) for c in ray[3:])),
                    torch.from_numpy(_np(w)), 0,
                )
                for ray, w in zip(rays, ws)
            ]
            cache[case] = dict(
                sn=sn, depth=depth,
                j_rgb=np.stack([_np(c) for c in acc]), j_t=np.stack([_np(t) for t in ts]),
                j_i=np.stack([_np(i) for i in idxs]),
                j_rays=[np.stack([_np(c) for c in r]).astype(np.float64) for r in rays],
                j_alive=np.stack([_np(w) > 0 for w in ws]),
                p_rgb=torch.stack(list(rgb)).numpy(), p_t=t_p.numpy(), p_i=i_p.numpy(),
                fed_t=np.stack([f[1][0].numpy() for f in fed]),
                fed_i=np.stack([f[2][0].numpy() for f in fed]),
            )
        return cache[case]

    return get


def _sphere_terms(sn, rays, idx):
    """float64 (disc/r^2, bq^2, det) of each lane's ray against sphere
    ``idx`` (the half-b discriminant and the full-form terms)."""
    c = sn["sph_center"].astype(np.float64)[idx]
    r2 = sn["sph_radius"].astype(np.float64)[idx] ** 2
    oc = rays[:3] - np.moveaxis(c, -1, 0)
    b = np.sum(rays[3:] * oc, axis=0)
    disc = b * b - (np.sum(oc * oc, axis=0) - r2)
    return disc / r2, 4.0 * b * b, 4.0 * disc


def _is_grazing(sn, rays, y, x, cands):
    """A lane is a grazing hit when a sphere among the candidate indices is
    met at |disc| < 1e-2 r^2 (float64, on the JAX ray of that level)."""
    n_s = len(sn["sph_radius"])
    for i in cands:
        if 0 <= i < n_s:
            g, _, _ = _sphere_terms(sn, rays[:, y, x], np.int64(i))
            if abs(g) < 1e-2:
                return True
    return False


@pytest.mark.parametrize("case", list(CASES))
def test_indices_match_jax_kernel(traced, case):
    r = traced(case)
    alive, ji, pi = r["j_alive"], r["j_i"], r["p_i"]
    assert ji.shape == pi.shape == (r["depth"] + 1, H, W)
    diff = alive & (ji != pi)
    assert diff.sum() <= 1e-3 * alive.sum(), f"{diff.sum()} of {alive.sum()} lanes differ"
    first = np.argmax(diff, axis=0)  # first differing level per lane
    for y, x in zip(*np.nonzero(diff.any(axis=0))):
        k = first[y, x]
        assert _is_grazing(r["sn"], r["j_rays"][k], y, x, (ji[k, y, x], pi[k, y, x])), (
            f"lane {(y, x)} level {k}: JAX index {ji[k, y, x]}, port {pi[k, y, x]} "
            "and neither is a grazing sphere hit"
        )
    # Lanes dead in both (same selections so far) carry (MISS_T, -1).
    agree = np.cumprod(~alive | (ji == pi), axis=0).astype(bool)
    dead = ~alive & agree
    assert (pi[dead] == -1).all() and (r["p_t"][dead] == np.float32(MISS_T)).all()


@pytest.mark.parametrize("case", list(CASES))
def test_t_matches_jax_kernel(traced, case):
    r = traced(case)
    sn, n_s = r["sn"], len(r["sn"]["sph_radius"])
    assert (r["fed_i"] == r["j_i"])[r["j_alive"]].mean() >= 0.999
    for k in range(r["depth"] + 1):
        m = r["j_alive"][k] & (r["fed_i"][k] == r["j_i"][k])
        jt, pt, idx = r["j_t"][k][m], r["fed_t"][k][m], r["j_i"][k][m]
        rays = r["j_rays"][k][:, m]
        slack = np.zeros_like(jt, dtype=np.float64)
        sph = (idx >= 0) & (idx < n_s)
        if sph.any():
            _, bq2, det = _sphere_terms(sn, rays[:, sph], idx[sph])
            slack[sph] = 4 * EPS32 * bq2 / np.sqrt(np.maximum(det, 1e-30)) / np.abs(jt[sph])
        rel = np.abs(pt.astype(np.float64) - jt) / np.abs(jt)
        bad = rel > 1e-5 + slack
        assert not bad.any(), (
            f"level {k}: {bad.sum()} of {m.sum()} lanes, worst rel {rel.max():.3g}"
        )


@pytest.mark.parametrize("case", list(CASES))
def test_rgb_matches_jax_kernel(traced, case):
    r = traced(case)
    jt, pt = r["j_t"].astype(np.float64), r["p_t"]
    drift = r["j_alive"] & ((r["j_i"] != r["p_i"]) | (np.abs(pt - jt) > 1e-5 * np.abs(jt)))
    off = ~np.isclose(r["p_rgb"], r["j_rgb"], rtol=5e-4, atol=5e-4).all(axis=0)
    assert off.mean() <= 1e-3, f"{off.sum()} pixels outside 5e-4"
    unexplained = off & ~drift.any(axis=0)
    assert not unexplained.any(), f"pixels {np.argwhere(unexplained)[:5]}"


def test_trace_soa_cpu_runs_plain_version():
    """trace_soa on CPU tensors is trace_whole's plain version and never
    counts a kernel launch."""
    scene = tscenes.sprint3_scene(device="cpu")
    tables = cuda_fold.fused_tables(scene)
    g = np.random.default_rng(0)
    d = g.normal(size=(3, 8, 16)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    o = V3(*(torch.zeros(()) for _ in range(3)))
    dv = V3(*(torch.from_numpy(c) for c in d))
    before = launches("trace_whole")
    acc = trace_soa(scene, o, dv, depth=2)
    want, _, _ = cuda_fold.trace_whole_reference(
        tables, o.broadcast_to((8, 16)), dv, torch.ones((8, 16)), 2
    )
    for a, b in zip(acc, want):
        assert torch.equal(a, b)
    assert launches("trace_whole") == before


def test_trace_whole_checks_inputs_and_dead_lanes():
    """Planes of another dtype, layout or shape are refused; lanes that
    start with zero throughput write (MISS_T, -1) and gather no light."""
    tables = cuda_fold.fused_tables(tscenes.sprint3_scene(device="cpu"))
    ones = torch.ones((4, 8))
    o = V3(ones * 0.0, ones * 0.0, ones * 0.0)
    d = V3(ones, ones * 0.0, ones * 0.0)
    with pytest.raises(ValueError, match="float32"):
        cuda_fold.trace_whole(tables, o, V3(d.x.double(), d.y, d.z), ones, 1)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_fold.trace_whole(tables, o, V3(d.x, d.y, torch.zeros(8, 4).t()), ones, 1)
    with pytest.raises(ValueError, match="shape"):
        cuda_fold.trace_whole(tables, o, d, torch.ones(4, 7), 1)
    w = ones.clone()
    w[:, :3] = 0.0
    rgb, t, i = cuda_fold.trace_whole(tables, o, d, w, 2)
    assert (i[:, :, :3] == -1).all() and (t[:, :, :3] == np.float32(MISS_T)).all()
    assert all((c[:, :3] == 0).all() and (c[:, 3:] > 0).all() for c in rgb)
    assert (i[0, :, 3:] == 0).all()  # the sphere at +x, straight ahead


def test_fused_class_and_table_layout():
    assert cuda_fold.resolve_unroll(1) == 1 and cuda_fold.resolve_unroll(64) == 16
    assert cuda_fold.resolve_gate_geom(64, 16) == cuda_fold.GATE_AABB
    assert cuda_fold.resolve_gate_geom(1, 1) == cuda_fold.GATE_SPHERE
    cuda_fold.check_fused_class(tscenes.grid_sphere_scene(64, device="cpu"), 10)
    cuda_fold.check_fused_class(tscenes.grid_sphere_scene(768, device="cpu"), 3)
    with pytest.raises(NotImplementedError, match="per-level"):
        cuda_fold.check_fused_class(tscenes.grid_sphere_scene(1024, device="cpu"), 3)
    with pytest.raises(NotImplementedError):
        cuda_fold.check_fused_class(tscenes.sprint3_scene(device="cpu"), 11)
    tables = cuda_fold.fused_tables(tscenes.mixed_primitive_scene(device="cpu"))
    c = tables.counts
    n_prim = c["n_s"] + c["n_w"] + c["n_b"]
    # Mirrors make_layout in csrc/trace_whole.cu.
    n_tab = (5 * c["n_s"] + 15 * c["n_w"] + 6 * c["n_b"] + 8 * n_prim
             + 11 * c["n_c"] + 6 + 6 * c["n_pt"] + 6 * c["n_sun"] + 10)
    assert tables.packed.shape == (n_tab,)
    assert tables.cols["sky"].shape == (10,)
