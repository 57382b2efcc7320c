"""The port's sharded paths on four gloo ranks on the CPU, against the
single-rank port and the JAX package's ``render_sharded``.

One module-scope spawn (``parallel/dryrun.spawn``, a 120 s join timeout, one
thread a rank) runs every request of ``REQUESTS`` on each of the four ranks
through ``parallel/dryrun.run_requests`` and returns numpy results; the
tests here compare them. Sharded images must equal the single-rank port
bit for bit: ``render`` on the ``px`` axis, and on the ``prim`` axis the
single-rank per-level loop around ``closest_hit_soa`` (the loop the
``prim`` ranks run, each on its slice of the spheres). Fit steps are held
to the JAX package's tolerances for the same check
(tests/test_parallel.py): the loss to rtol 1e-5 and the parameters to atol
1e-5 (hard), rtol 1e-4 and atol 2e-5 (soft); their gradients to 1e-5
(hard) and 1e-4 (soft) of each leaf's largest.
"""

import jax
import numpy as np
import pytest
import torch

from raytracer_tpu.models import scenes as jscenes
from raytracer_tpu.oracle import numpy_ref
from raytracer_tpu.parallel import make_mesh as j_make_mesh
from raytracer_tpu.parallel import render_sharded as j_render_sharded
from raytracer_tpu_torch import closest_hit_soa, make_fit_step, render, render_soft
from raytracer_tpu_torch.models import scenes as tscenes
from raytracer_tpu_torch.ops.tonemap import reinhard_tonemap
from raytracer_tpu_torch.ops.trace import raygen_tile, render_tile, resolve_fold_fn
from raytracer_tpu_torch.parallel.dryrun import run_requests, spawn

torch.set_num_threads(1)

W, H = 40, 24
GRID8 = ("grid_sphere_scene", (8,), {"distance": 4.0})
GRID4 = ("grid_sphere_scene", (4,), {"distance": 4.0})
# 13 spheres over prim=4: padded to 16, the last shard is sphere 12 and
# three pads in one chunk, and the camera rays hit sphere 12.
GRID13 = ("grid_sphere_scene", (13,), {"distance": 4.0})
MIXED = ("mixed_primitive_scene", (), {})
PERTURB = 0.1


def _scene(spec):
    name, args, kwargs = spec
    return getattr(tscenes, name)(*args, **kwargs, device="cpu")


def _cam():
    return tscenes.reference_demo_camera(device="cpu")


def _start(spec):
    """The scene with every sphere centre moved by ``PERTURB``."""
    s = _scene(spec)
    return s.replace(spheres=s.spheres.replace(center=s.spheres.center + PERTURB))


def _hard_target(spec, depth):
    with torch.no_grad():
        return render(_scene(spec), _cam(), W, H, depth=depth, device="cpu").numpy()


def _soft_target(spec, depth):
    with torch.no_grad():
        return render_soft(_scene(spec), _cam(), W, H, tau=0.02, tonemap=False, depth=depth,
                           device="cpu").numpy()


RENDERS = [  # (name, scene, size, depth, mesh, fold); H = 23 rows are uneven
    ("grid8_4x1", GRID8, (W, 23), 2, (4, 1), "auto"),
    ("grid8_2x2", GRID8, (W, H), 2, (2, 2), "auto"),
    ("grid8_1x4", GRID8, (W, H), 2, (1, 4), "auto"),
    ("uneven_2x2", GRID8, (W, 23), 2, (2, 2), "auto"),
    ("padding_1x4", GRID13, (64, 48), 1, (1, 4), "auto"),
    ("mixed_4x1", MIXED, (W, H), 2, (4, 1), "auto"),
    ("mixed_2x2", MIXED, (W, H), 2, (2, 2), "auto"),
    ("jnp_2x2", GRID8, (W, H), 2, (2, 2), "jnp"),
]
SOFT = [  # (name, scene, size, depth, mesh): the soft render, rows over every rank
    ("soft_mixed_2x2", MIXED, (W, 23), 1, (2, 2)),
]
FITS = [  # (name, soft, scene, depth, mesh)
    ("hard_4x1", False, GRID4, 1, (4, 1)),
    ("hard_2x2", False, GRID4, 1, (2, 2)),
    ("soft_2x2", True, GRID4, 1, (2, 2)),
]


def _requests():
    reqs = [{"kind": "render", "scene": spec, "size": size, "depth": depth, "mesh": mesh,
             "fold": fold} for _, spec, size, depth, mesh, fold in RENDERS]
    reqs += [{"kind": "soft", "scene": spec, "size": size, "depth": depth, "mesh": mesh,
              "tau": 0.02} for _, spec, size, depth, mesh in SOFT]
    for _, soft, spec, depth, mesh in FITS:
        start = _start(spec)
        reqs.append({
            "kind": "fit", "soft": soft, "depth": depth, "mesh": mesh, "size": (W, H),
            "scene": spec, "center": start.spheres.center.numpy(),
            "target": (_soft_target if soft else _hard_target)(spec, depth),
            **({"tau": 0.02, "tonemap": False} if soft else {}),
        })
    reqs.append({"kind": "legs"})
    return reqs


@pytest.fixture(scope="module")
def ranks():
    """Every request's result on each of the four ranks, by name."""
    out = spawn(run_requests, 4, args=("cpu", _requests()), timeout_s=120.0)
    names = [r[0] for r in RENDERS + SOFT] + [f[0] for f in FITS] + ["legs"]
    return [dict(zip(names, rank, strict=True)) for rank in out]


def _loop_render(spec, size, depth, fold):
    """The single-rank per-level loop around ``closest_hit_soa``, tone-mapped."""
    fold_fn = resolve_fold_fn(fold)

    def hit(sc, o, d, active=None):
        return closest_hit_soa(sc, o, d, fold_fn=fold_fn, active=active)

    with torch.no_grad():
        rad = render_tile(_scene(spec), _cam(), *size, depth=depth, closest_hit_fn=hit)
    return reinhard_tonemap(rad.stacked()).numpy()


def _want(spec, size, depth, mesh, fold):
    if mesh[1] == 1 and fold == "auto":
        with torch.no_grad():
            return render(_scene(spec), _cam(), *size, depth=depth, device="cpu").numpy()
    return _loop_render(spec, size, depth, fold)


def _check_render(ranks, name):
    _, spec, size, depth, mesh, fold = next(r for r in RENDERS if r[0] == name)
    want = _want(spec, size, depth, mesh, fold)
    for rank in ranks:
        got = rank[name]["image"]
        assert got.shape == (size[1], size[0], 3)
        np.testing.assert_array_equal(got, want)
    return want


@pytest.mark.parametrize("name", ["grid8_4x1", "grid8_2x2", "grid8_1x4"])
def test_sharded_render_equals_single_rank(ranks, name):
    """Every rank returns the whole frame, bit for bit the single-rank one
    (on (4, 1) at H = 23: 6 rows a rank, the last rank's sixth a pad row);
    the per-level loop that ``prim`` runs is within 1e-4 of ``render`` (the
    JAX package's allowance for its own two routes)."""
    want = _check_render(ranks, name)
    size = next(r[2] for r in RENDERS if r[0] == name)
    with torch.no_grad():
        direct = render(_scene(GRID8), _cam(), *size, depth=2, device="cpu").numpy()
    np.testing.assert_allclose(want, direct, atol=1e-4, rtol=0)


def test_uneven_rows_and_prim_padding(ranks):
    """H = 23 over 2 row tiles of 2 ``prim`` ranks (pad rows traced, then
    cropped; the 4-tile case is ``grid8_4x1``); 13 spheres over prim=4,
    whose last shard's one chunk holds sphere 12 and three pad spheres at
    1e8 of radius 0: the chunk's gate spans 1e8, and the rays that hit
    sphere 12 must still find it."""
    _check_render(ranks, "uneven_2x2")
    _check_render(ranks, "padding_1x4")
    o, d = raygen_tile(_cam(), 64, 48)
    idx = closest_hit_soa(_scene(GRID13), o, d).prim_index
    assert int((idx == 12).sum()) > 0


def test_mixed_scene_with_boxes(ranks):
    _check_render(ranks, "mixed_4x1")
    _check_render(ranks, "mixed_2x2")


def test_sharded_soft_render_equals_single_rank(ranks):
    """The soft render over the four ranks' rows (H = 23: 6 rows a rank,
    one pad row) equals ``render_soft`` bit for bit on every rank; it makes
    one collective, the gather of the tiles."""
    _, spec, size, depth, mesh = SOFT[0]
    with torch.no_grad():
        want = render_soft(_scene(spec), _cam(), *size, tau=0.02, depth=depth,
                           device="cpu").numpy()
    for rank in ranks:
        np.testing.assert_array_equal(rank["soft_mixed_2x2"]["image"], want)
    assert ranks[0]["soft_mixed_2x2"]["census"] == [("all_gather", 4, 6 * W * 3,
                                                      "torch.float32")]


def test_fit_steps_match_single_rank(ranks):
    """One meshed step against one single-rank step from the same start:
    hard on (4, 1) and (2, 2) (the ``prim`` ranks' gradients through the
    hit combine), soft with a reflection on (2, 2) (rows over every
    rank); the parameters stay the same on every rank, bit for bit.

    Adam's first update is about ``lr * sign(g)``, and the loss does not
    read the backward, so the gradients the step took (summed over the
    mesh) are held to the single-rank ones too: within ``rtol`` of the
    largest gradient of the leaf (1e-5 hard, 1e-4 soft), which a gradient
    scaled by ``1 / prim`` or missing a rank's rows is far outside."""
    for name, soft, spec, depth, _ in FITS:
        start = _start(spec)
        if soft:
            init_fn, step_fn = make_fit_step(W, H, soft=True, soft_tau=0.02, tonemap=False,
                                             depth=depth, device="cpu")
            target = torch.from_numpy(_soft_target(spec, depth))
        else:
            init_fn, step_fn = make_fit_step(W, H, depth=depth, device="cpu")
            target = torch.from_numpy(_hard_target(spec, depth))
        state, loss = step_fn(init_fn(start), start, _cam(), target)
        rtol, atol = (1e-4, 2e-5) if soft else (1e-5, 1e-5)
        for rank in ranks:
            got = rank[name]
            np.testing.assert_allclose(got["loss"], float(loss), rtol=rtol, err_msg=name)
            for k, v in state.params.items():
                assert np.isfinite(got["params"][k]).all()
                np.testing.assert_allclose(got["params"][k], v.detach().numpy(), atol=atol,
                                           rtol=0, err_msg=f"{name} {k}")
                np.testing.assert_array_equal(got["params"][k], ranks[0][name]["params"][k])
                g = v.grad.numpy()
                err = np.abs(got["grads"][k] - g).max() / np.abs(g).max()
                assert err <= rtol, f"{name} grad {k}: {err:.3g} of its largest"


def test_collective_census(ranks):
    """The counterpart of tests/test_scaling_evidence.py: a ``px``-only
    render makes no collective a level, only the final gather of the
    tiles; a ``px``-only fit step only parameter-sized sums and the scalar
    loss. On ``prim`` each level makes three: the gather of ``t``, the
    float record's sum (15 planes) and the int record's (index, hit)."""
    rows = 6  # ceil(23 / 4) rows a rank on (4, 1); 2 * 6 on (2, 2) at H = 24
    assert ranks[0]["grid8_4x1"]["census"] == [("all_gather", 4, rows * W * 3, "torch.float32")]
    sizes = {4 * 3, 1}  # grid-4's centres and colours, [4, 3] each; the loss
    fit = ranks[0]["hard_4x1"]["census"]
    assert fit and all(k == "all_reduce" and g == 4 and n in sizes for k, g, n, _ in fit)
    assert [n for *_, n, _ in fit].count(1) == 1
    prim = ranks[0]["grid8_2x2"]["census"]
    levels = 3  # depth 2
    per_level = [("all_gather", 2, rows * 2 * W, "torch.float32"),
                 ("all_reduce", 2, 15 * rows * 2 * W, "torch.float32"),
                 ("all_reduce", 2, 2 * rows * 2 * W, "torch.int32")]
    assert prim == per_level * levels + [("all_gather", 2, rows * 2 * W * 3, "torch.float32")]


def test_dryrun_multichip_legs(ranks):
    """``dryrun_multichip(4)``'s legs on the same four ranks: the (2, 2)
    render, the mixed scene, the (1, 4) leg, a hard and a soft fit step;
    every rank reports the same finite losses."""
    losses = [r["legs"] for r in ranks]
    assert all(np.isfinite(v) for v in losses[0].values())
    assert all(x == losses[0] for x in losses)


def test_render_sharded_matches_jax_render_sharded(ranks):
    """The port's (2, 2) ``render_sharded`` with ``fold="jnp"`` against
    the JAX package's on a (2, 2) mesh of four CPU devices, within the
    tolerance of tests/test_torch_render.py: 5e-4 everywhere but at sphere
    silhouettes, where the two normalise camera rays with rsqrts that
    differ in the last bit; there the port must agree with the float64
    oracle to 1e-3."""
    jscene, jcam = jscenes.grid_sphere_scene(8, distance=4.0), jscenes.reference_demo_camera()
    mesh = j_make_mesh(px=2, prim=2, devices=jax.devices()[:4])
    want = np.asarray(j_render_sharded(jscene, jcam, W, H, mesh=mesh, depth=2, fold="jnp"))
    got = ranks[0]["jnp_2x2"]["image"]
    off = ~np.isclose(got, want, rtol=5e-4, atol=5e-4).all(axis=-1)
    assert off.mean() <= 2e-3, f"{off.sum()} pixels differ"
    exact = numpy_ref.render_oracle(jscene, jcam, W, H, depth=2, dtype=np.float64)
    np.testing.assert_allclose(got[off], exact[off], rtol=0, atol=1e-3)
