"""The port's soft renderer gradients on the CPU (the soft kernels' plain
versions): ``_SoftTrace`` (the level-by-level backward the CUDA kernels
compute) against autograd straight through the plain level, and both
against ``jax.vjp`` of the JAX package's ``trace_soft`` (its XLA path);
finite differences; the soft fit step.

Tolerances. Against the direct autograd, every leaf and ray cotangent
agrees to 1e-4 of its largest entry (the two take the same derivatives; the
backward sums its table cotangents in float64, autograd in float32).
Against the JAX package: every colour, material, light, sky, wall and box
cotangent to 1e-3 of its largest entry; the sphere centres and radii, the
ray directions and tau, tau_z (which pass through the depth softmax's
``max(t - t_ref, 0)`` kink, where the anchor primitive sits by construction
and float32 picks a side per engine) with the JAX package's kink-robust
metrics, cosine > 0.99 and relative L2 <= 0.15 (tests/test_pallas_soft.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracer_tpu.core.v3 import V3 as JV3
from raytracer_tpu.diff import soft as jsoft
from raytracer_tpu.models import scenes as jscenes
from raytracer_tpu.oracle.numpy_ref import scene_to_numpy
from raytracer_tpu_torch import default_params, make_fit_step, merge_params, render_soft
from raytracer_tpu_torch.core.types import Boxes, Lights, Materials, Scene, Sky, Spheres, Walls
from raytracer_tpu_torch.core.v3 import V3
from raytracer_tpu_torch.diff import soft as tsoft
from raytracer_tpu_torch.models import scenes as tscenes
from raytracer_tpu_torch.ops import cuda_soft
from raytracer_tpu_torch.ops.trace import raygen_tile
from raytracer_tpu_torch.utils.profiler import launches

torch.set_num_threads(1)

W, H = 64, 32
TAU, TAU_Z = 0.02, 0.05
# Leaves that pass through the soft hit distance and so the softmax kink.
KINK = {"sph_center", "sph_radius", "wall_position", "wall_normal", "wall_length",
        "wall_width", "box_min", "box_max", "dx", "dy", "dz", "tau", "tau_z"}


def leaf_scene(d: dict):
    """A port scene whose every tensor is a leaf that requires grad, from a
    ``scene_to_numpy`` dict: ``(scene, {key: leaf})``."""
    t = {k: torch.tensor(np.asarray(v, np.float32), requires_grad=True) for k, v in d.items()}

    def mat(p):
        return Materials(t[p + "_color"], t[p + "_ambient"], t[p + "_metallic"],
                         t[p + "_diffuse"], t[p + "_specular"], t[p + "_exponent"])

    scene = Scene(
        Spheres(t["sph_center"], t["sph_radius"], mat("sph")),
        Walls(t["wall_position"], t["wall_normal"], t["wall_length"], t["wall_width"],
              mat("wall")),
        Boxes(t["box_min"], t["box_max"], mat("box")),
        Lights(t["light_pos"], t["light_color"], t["sun_dir"], t["sun_color"]),
        Sky(t["ground"], t["horizon"], t["zenith"], t["sky_exp"]),
    )
    return scene, t


def camera_rays():
    o, d = raygen_tile(tscenes.reference_demo_camera(device="cpu"), W, H)
    return o.broadcast_to(d.x.shape), d


def image_cotangent(seed=0):
    return np.random.default_rng(seed).standard_normal((H, W, 3)).astype(np.float32)


def port_grads(js, fn, depth=1):
    """Cotangents of every scene leaf, the ray directions, tau and tau_z for
    the seeded image cotangent, through ``fn`` (``trace_soft`` or
    ``trace_soft_reference``)."""
    scene, leaves = leaf_scene(scene_to_numpy(js, np.float32))
    o, d = camera_rays()
    d = V3(*(c.clone().requires_grad_(True) for c in d))
    tau = torch.tensor(TAU, requires_grad=True)
    tau_z = torch.tensor(TAU_Z, requires_grad=True)
    img = fn(scene, o, d, tau=tau, tau_z=tau_z, depth=depth).stacked()
    keys = list(leaves)
    inputs = [leaves[k] for k in keys] + list(d) + [tau, tau_z]
    grads = torch.autograd.grad((img * torch.from_numpy(image_cotangent())).sum(), inputs,
                                allow_unused=True)
    out = {k: (g if g is not None else torch.zeros_like(x)).numpy()
           for k, g, x in zip(keys + ["dx", "dy", "dz", "tau", "tau_z"], grads, inputs)}
    return img.detach().numpy(), out


@pytest.mark.parametrize("name", ["grid16", "mixed"])
def test_soft_trace_matches_direct_autograd(name):
    """``_SoftTrace`` (forward with residuals, then the per-level backward
    with the carry's cotangent given to each primitive on its own) against
    autograd straight through ``soft_level_reference``, at depth 1: every
    scene leaf, the ray directions, tau and tau_z."""
    js = (lambda: jscenes.grid_sphere_scene(16, distance=4.0)) if name == "grid16" \
        else jscenes.mixed_primitive_scene
    img_f, g_f = port_grads(js(), tsoft.trace_soft)
    img_r, g_r = port_grads(js(), tsoft.trace_soft_reference)
    np.testing.assert_array_equal(img_f, img_r)
    for k in g_r:
        if not g_r[k].size:  # an absent group (grid-16 has no walls)
            continue
        scale = max(float(np.abs(g_r[k]).max()), 1e-30)
        np.testing.assert_allclose(g_f[k], g_r[k], rtol=0, atol=1e-4 * scale, err_msg=k)
    assert np.abs(g_r["sph_center"]).max() > 0 and np.abs(g_r["tau"]).max() > 0


@pytest.fixture(scope="module")
def jax_mixed():
    """One ``jax.vjp`` of the JAX ``trace_soft`` (depth 1) over the mixed
    scene (spheres, walls, boxes, a point light, a sun), the ray directions,
    tau and tau_z, for the seeded image cotangent."""
    js = jscenes.mixed_primitive_scene()
    o, d = camera_rays()
    jo = JV3(*(jnp.asarray(c.numpy()) for c in o))
    jd = JV3(*(jnp.asarray(c.numpy()) for c in d))
    img, vjp = jax.vjp(
        lambda sc, dd, ta, tz: jsoft.trace_soft(sc, jo, dd, tau=ta, tau_z=tz,
                                                depth=1).stacked(),
        js, jd, jnp.float32(TAU), jnp.float32(TAU_Z))
    g_sc, g_d, g_tau, g_tz = vjp(jnp.asarray(image_cotangent()))
    out = scene_to_numpy(g_sc, np.float32)
    out.update(dx=np.asarray(g_d.x), dy=np.asarray(g_d.y), dz=np.asarray(g_d.z),
               tau=np.asarray(g_tau), tau_z=np.asarray(g_tz))
    return js, np.asarray(img), out


def test_gradients_match_jax(jax_mixed):
    """The mixed scene's image and every non-geometry cotangent (colours,
    materials, lights, sun, sky) against ``jax.vjp``, to 1e-3 of each
    leaf's largest entry, through ``_SoftTrace`` and through the direct
    autograd alike."""
    js, img_j, g_j = jax_mixed
    for fn in (tsoft.trace_soft, tsoft.trace_soft_reference):
        img, g = port_grads(js, fn)
        np.testing.assert_allclose(img, img_j, atol=2e-4, rtol=2e-4)
        checked = 0
        for k in sorted(set(g_j) - KINK):
            scale = float(np.abs(g_j[k]).max())
            if scale == 0.0:
                assert float(np.abs(g[k]).max()) == 0.0, k
                continue
            np.testing.assert_allclose(g[k], g_j[k], rtol=0, atol=1e-3 * scale, err_msg=k)
            checked += 1
        assert checked >= 20


def test_geometry_gradients_kink_robust(jax_mixed):
    """The cotangents through the soft hit distance (sphere centres and
    radii, wall and box geometry, ray directions, tau, tau_z) against
    ``jax.vjp`` with the kink-robust metrics: cosine > 0.99 and relative L2
    <= 0.15, through ``_SoftTrace`` and the direct autograd alike."""
    js, _, g_j = jax_mixed
    for fn in (tsoft.trace_soft, tsoft.trace_soft_reference):
        _, g = port_grads(js, fn)
        for k in sorted(KINK & set(g_j)):
            a, b = g[k].ravel().astype(np.float64), g_j[k].ravel().astype(np.float64)
            if not np.abs(b).max():
                assert not np.abs(a).max(), k
                continue
            cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
            assert cos > 0.99, (k, cos)
            assert np.linalg.norm(a - b) <= 0.15 * np.linalg.norm(b), k


def test_center_gradient_matches_finite_differences():
    """One centre coordinate's gradient through ``_SoftTrace`` against a
    central difference of the loss (grid-4, depth 0, h = 1e-3), the JAX
    package's protocol (tests/test_pallas_soft.py)."""
    scene = tscenes.grid_sphere_scene(4, distance=4.0, device="cpu")
    cam = tscenes.reference_demo_camera(device="cpu")
    target = render_soft(scene, cam, W, H, tau=0.02, tonemap=False, device="cpu")

    def loss(x):
        center = scene.spheres.center.clone()
        center[0, 1] = center[0, 1] + x
        sc = scene.replace(spheres=scene.spheres.replace(center=center))
        img = render_soft(sc, cam, W, H, tau=0.02, tonemap=False, device="cpu")
        return torch.mean((img - target) ** 2)

    x = torch.tensor(0.05, requires_grad=True)
    (g,) = torch.autograd.grad(loss(x), x)
    h = 1e-3
    with torch.no_grad():
        fd = float((loss(torch.tensor(0.05 + h)) - loss(torch.tensor(0.05 - h))) / (2 * h))
    assert np.isfinite(float(g)) and np.isfinite(fd)
    assert abs(float(g) - fd) <= 0.05 * max(abs(fd), 1e-6), (float(g), fd)


def test_soft_fit_lowers_center_error():
    """``make_fit_step(soft=True)`` from centres perturbed by up to 0.15
    (numpy seed) toward the true scene's soft render (grid-4, 64x48, tau
    0.01, depth 0): the silhouette gradient the hard fit lacks. The loss and
    the mean centre error both fall within 25 steps."""
    w, h = 64, 48
    truth = tscenes.grid_sphere_scene(4, distance=4.0, device="cpu")
    cam = tscenes.reference_demo_camera(device="cpu")
    with torch.no_grad():
        target = render_soft(truth, cam, w, h, tau=0.01, tonemap=False, device="cpu")
    pert = torch.from_numpy(np.random.default_rng(0).uniform(-0.15, 0.15, (4, 3)).astype(np.float32))
    start = merge_params(truth, {"center": default_params(truth)["center"] + pert})
    init_fn, step_fn = make_fit_step(
        w, h, depth=0, soft=True, soft_tau=0.01, tonemap=False, device="cpu",
        optimizer=lambda p: torch.optim.Adam([p["center"]], lr=2e-2, betas=(0.9, 0.999),
                                             eps=1e-8),
    )
    state = init_fn(start)
    losses = []
    for _ in range(25):
        state, loss = step_fn(state, start, cam, target)
        losses.append(float(loss))
    err0 = float(pert.abs().mean())
    err = float((state.params["center"].detach() - truth.spheres.center).abs().mean())
    assert all(np.isfinite(losses)) and losses[-1] < 0.5 * losses[0], losses
    assert err < 0.8 * err0, (err0, err)


def test_soft_level_wrappers():
    """On CPU tensors the wrappers run the plain versions and launch
    nothing; they reject planes of another dtype or shape and a residual of
    the wrong depth; a frame whose rays all miss has finite gradients, 0 for
    its spheres."""
    scene = tscenes.grid_sphere_scene(4, distance=4.0, device="cpu")
    tables = cuda_soft.soft_tables(scene, TAU, TAU_Z)
    gates = cuda_soft.soft_gate_tables(scene, TAU)
    o, d = camera_rays()
    w = torch.ones_like(d.x)
    acc = V3(*(torch.zeros_like(w) for _ in range(3)))
    before = (launches("soft_level"), launches("soft_level_bwd"))
    with torch.no_grad():
        out = cuda_soft.soft_level(tables, gates, o, d, w, acc, False, True)
        want = cuda_soft.soft_level_reference(tables, o, d, w, acc, False, True)
    for a, b in zip(out, want):
        assert torch.equal(torch.stack(list(a)) if isinstance(a, V3) else a,
                           torch.stack(list(b)) if isinstance(b, V3) else b)
    assert out[4].shape == (16, H, W)
    with pytest.raises(ValueError, match="float32"):
        cuda_soft.soft_level(tables, gates, o, d, w.double(), acc, False)
    with pytest.raises(ValueError, match="shape"):
        cuda_soft.soft_level(tables, gates, o, V3(*(c[:, :8].contiguous() for c in d)), w, acc, False)
    sums = torch.zeros(tables.packed.shape, dtype=torch.float64)
    with pytest.raises(ValueError, match="shape"):
        cuda_soft.soft_level_bwd(tables, gates, o, d, w, out[4], acc, None, True, sums)
    assert (launches("soft_level"), launches("soft_level_bwd")) == before
    # All rays look away from the scene.
    center = scene.spheres.center.clone().requires_grad_(True)
    far = scene.replace(spheres=scene.spheres.replace(center=center))
    img = tsoft.trace_soft(far, o, V3(*(-c for c in d)), tau=TAU, tau_z=TAU_Z, depth=1)
    (gc,) = torch.autograd.grad(img.stacked().square().sum(), center)
    assert torch.isfinite(img.stacked()).all() and torch.isfinite(gc).all()
    assert float(gc.abs().max()) == 0.0
