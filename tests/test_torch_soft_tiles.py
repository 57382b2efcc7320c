"""The soft kernels' sphere ring on the CPU: the launch plan at any sphere
count, the plain soft level and its backward past the JAX kernel's sphere
cap (grid-4104, where the JAX package takes its XLA path), the lane order
of the bounce levels, and the skipped padding spheres.

Grid-4104 stands at distance 4, as every grid of tests/test_torch_soft*.py,
and is traced at depth 0: one level. At depth 1 the bounce rays are built
from level 0's expected surface, which XLA's FMA contraction on the CPU
moves (ROADMAP, deliberate differences), and 1 of the frame's 288 values
then differs by 4.3e-4; the level pair is held against the kernels on the
card (chip_smoke.py, grid-4096 and grid-8192).

The plan's shared memory must fit a block of the H100 (232,448 bytes) and
must not grow with the spheres. Against the JAX package the tolerances are
those of tests/test_torch_soft.py and tests/test_torch_soft_grad.py: the
image to atol = rtol = 2e-4, the colour cotangents to 1e-3 of their
largest entry, the centre cotangents (through the depth softmax's kink)
with cosine > 0.99 and relative L2 <= 0.15. The lane order and the skipped
padding spheres change no result on rays that miss the pads: those
comparisons are bit for bit. On a ray aimed at a pad they differ from the
JAX package, which keeps its pads, and the last test pins how.
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
from raytracer_tpu_torch.core.types import Scene
from raytracer_tpu_torch.core.v3 import V3
from raytracer_tpu_torch.diff import soft as tsoft
from raytracer_tpu_torch.models import scenes as tscenes
from raytracer_tpu_torch.ops import cuda_soft
from raytracer_tpu_torch.ops.trace import raygen_tile

torch.set_num_threads(1)

TAU, TAU_Z = 0.02, 0.05
BIG = 4104  # past the JAX kernel's 4096 spheres (pallas_soft._SOFT_MAX_SPHERES)
W, H = 12, 8


def camera_rays(w, h):
    o, d = raygen_tile(tscenes.reference_demo_camera(device="cpu"), w, h)
    return o.broadcast_to(d.x.shape), d


def image_cotangent():
    return np.random.default_rng(0).standard_normal((H, W, 3)).astype(np.float32)


def test_launch_plan_any_sphere_count():
    """The plan at 1 to 16,384 spheres: tiles of whole 32-chunk words that
    cover the chunks, in both kernels' rings, and the same shared memory for
    every count, within a block's."""
    plans = set()
    for n in (1, 64, 1024, 2048, 4096, 4104, 16384):
        counts = cuda_soft._counts(tscenes.grid_sphere_scene(n, device="cpu"))
        p = cuda_soft.soft_launch_plan(counts)
        for key in ("", "_bwd"):
            t, n_t = p["tile_chunks" + key], p["n_tiles" + key]
            assert t % 32 == 0 and (n_t - 1) * t < counts["n_chunks"] <= n_t * t
        assert p["resident"] == (p["n_tiles"] <= 2)
        assert max(p["smem"], p["smem_bwd"]) <= cuda_soft._SMEM_MAX
        plans.add((p["smem"], p["smem_bwd"]))
    assert len(plans) == 1, plans


@pytest.fixture(scope="module")
def jax_big():
    """One ``jax.vjp`` of the JAX ``trace_soft`` (depth 0, its XLA path)
    on grid-4104 for a seeded image cotangent: the scene, the image, and
    the sphere centres' and colours' cotangents."""
    js = jscenes.grid_sphere_scene(BIG, distance=4.0)
    o, d = camera_rays(W, H)
    jo = JV3(*(jnp.asarray(c.numpy()) for c in o))
    jd = JV3(*(jnp.asarray(c.numpy()) for c in d))
    img, vjp = jax.vjp(
        lambda sc: jsoft.trace_soft(sc, jo, jd, tau=TAU, tau_z=TAU_Z, depth=0).stacked(), js)
    (g_sc,) = vjp(jnp.asarray(image_cotangent()))
    g = scene_to_numpy(g_sc, np.float32)
    return js, np.asarray(img), g["sph_center"], g["sph_color"]


def test_plain_level_past_the_jax_cap(jax_big):
    """``trace_soft`` (the plain soft level) on grid-4104 against the JAX
    package's image."""
    js, img_j, _, _ = jax_big
    ts = Scene.from_numpy(scene_to_numpy(js), device="cpu")
    o, d = camera_rays(W, H)
    with torch.no_grad():
        img = tsoft.trace_soft(ts, o, d, tau=TAU, tau_z=TAU_Z, depth=0).stacked()
    np.testing.assert_allclose(img.numpy(), img_j, atol=2e-4, rtol=2e-4)
    assert float(np.abs(img_j).max()) > 0.0


def test_plain_backward_past_the_jax_cap(jax_big):
    """``_SoftTrace``'s backward (the plain level backward) on grid-4104
    against ``jax.vjp``: the colours to 1e-3 of their largest cotangent,
    the centres with the kink-robust metrics."""
    js, _, g_c, g_col = jax_big
    ts = Scene.from_numpy(scene_to_numpy(js), device="cpu")
    center = ts.spheres.center.clone().requires_grad_(True)
    color = ts.spheres.material.color.clone().requires_grad_(True)
    sp = ts.spheres.replace(center=center, material=ts.spheres.material.replace(color=color))
    o, d = camera_rays(W, H)
    img = tsoft.trace_soft(ts.replace(spheres=sp), o, d, tau=TAU, tau_z=TAU_Z, depth=0)
    gc, gcol = torch.autograd.grad((img.stacked() * torch.from_numpy(image_cotangent())).sum(),
                                   [center, color])
    scale = float(np.abs(g_col).max())
    assert scale > 0.0
    np.testing.assert_allclose(gcol.numpy(), g_col, rtol=0, atol=1e-3 * scale)
    a, b = gc.numpy().ravel().astype(np.float64), g_c.ravel().astype(np.float64)
    assert float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b))) > 0.99
    assert np.linalg.norm(a - b) <= 0.15 * np.linalg.norm(b)


def _trace_with_grads(scene, o, d):
    """``soft_levels`` (depth 1, with residuals) and ``soft_levels_bwd`` for
    a seeded image cotangent: the image, the ray cotangents, the table's."""
    tables = cuda_soft.soft_tables(scene, TAU, TAU_Z)
    gates = cuda_soft.soft_gate_tables(scene, TAU)
    with torch.no_grad():
        rgb, levels = cuda_soft.soft_levels(tables, gates, o, d, 1, emit_res=True)
    ct = V3(*(torch.from_numpy(c) for c in
              np.random.default_rng(1).standard_normal((3, *d.x.shape)).astype(np.float32)))
    ct_o, ct_d, ct_packed = cuda_soft.soft_levels_bwd(tables, gates, levels, ct)
    return [*rgb, *ct_o, *ct_d, ct_packed], levels


def test_lane_order_changes_nothing(monkeypatch):
    """Every level of grid-64 launched in ``soft_lane_order`` (a
    permutation) gives the image, the ray cotangents and the table's
    cotangent of the natural order, bit for bit; a malformed order is
    refused."""
    scene = tscenes.grid_sphere_scene(64, device="cpu")
    o, d = camera_rays(24, 16)
    order = cuda_soft.soft_lane_order(o, d)
    assert order.dtype == torch.int32
    assert torch.equal(torch.sort(order.long()).values, torch.arange(24 * 16))
    assert not torch.equal(order.long(), torch.arange(24 * 16))
    monkeypatch.setattr(cuda_soft, "_orders_level", lambda counts, k: False)
    want, levels = _trace_with_grads(scene, o, d)
    assert all(lv[4] is None for lv in levels)
    monkeypatch.setattr(cuda_soft, "_orders_level", lambda counts, k: True)
    got, levels = _trace_with_grads(scene, o, d)
    assert all(lv[4] is not None for lv in levels)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    tables = cuda_soft.soft_tables(scene, TAU, TAU_Z)
    w = torch.ones_like(d.x)
    with pytest.raises(ValueError, match="int32"):
        cuda_soft.soft_level(tables, None, o, d, w, V3(w, w, w), False, order=order.long())


@pytest.mark.parametrize("name", ["grid60", "mixed"])
def test_padding_spheres_skipped(monkeypatch, name):
    """The plain level and its backward skip the padding spheres (grid-60:
    4 in its last chunk; the mixed scene: 6 of its one chunk, with walls,
    boxes and a sun) and give, bit for bit, what they gave running every
    chunk's 8 spheres, on camera rays, which miss the pads."""
    scene = (tscenes.grid_sphere_scene(60, device="cpu") if name == "grid60"
             else tscenes.mixed_primitive_scene(device="cpu"))
    o, d = camera_rays(24, 16)
    got, _ = _trace_with_grads(scene, o, d)
    monkeypatch.setattr(cuda_soft, "_chunk_size", lambda counts, c: cuda_soft.SOFT_CHUNK)
    want, _ = _trace_with_grads(scene, o, d)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_padding_spheres_skipped_unlike_jax_on_rays_aimed_at_a_pad(monkeypatch):
    """Where skipping the padding spheres differs from the JAX package:
    grid-60 (4 pads at centre 1e8, which the JAX package's sphere scan
    keeps) seen from (20, 20, 20) on 64 rays within ~2e-4 rad of the pads'
    direction, past every other primitive. A pad's discriminant is a
    difference of two float32 numbers near 3e16 (one ulp is 2e9), so on
    some of these rays it rounds to 0 or above and the pad's coverage to
    0.5 or 1. The JAX package's image is then dark on those rays (black
    here); the port's shows the sky on every ray, and agrees with the JAX
    package's on the others. With its pads kept, the port is dark exactly
    where its own pad coverage is above 0 and unchanged, bit for bit,
    elsewhere."""
    js = jscenes.grid_sphere_scene(60, distance=4.0)
    ts = Scene.from_numpy(scene_to_numpy(js), device="cpu")
    rng = np.random.default_rng(0)
    v = np.ones(3) / np.sqrt(3.0) + 2e-4 * rng.standard_normal((8, 8, 3))
    v = (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)
    d = V3(*(torch.from_numpy(np.ascontiguousarray(v[..., k])) for k in range(3)))
    o = V3(*(torch.full((8, 8), 20.0) for _ in range(3)))
    pad = {k: torch.tensor(x) for k, x in (("cx", 1e8), ("cy", 1e8), ("cz", 1e8), ("r", 1e-3))}
    aimed = (tsoft._sphere_alpha_t_scalar(pad, o, d, torch.tensor(TAU))[0] > 0).numpy()
    with torch.no_grad():
        skip = tsoft.trace_soft(ts, o, d, tau=TAU, tau_z=TAU_Z, depth=0).stacked().numpy()
        monkeypatch.setattr(cuda_soft, "_chunk_size", lambda counts, c: cuda_soft.SOFT_CHUNK)
        keep = tsoft.trace_soft(ts, o, d, tau=TAU, tau_z=TAU_Z, depth=0).stacked().numpy()
    jo = JV3(*(jnp.asarray(c.numpy()) for c in o))
    jd = JV3(*(jnp.asarray(c.numpy()) for c in d))
    img_j = np.asarray(jsoft.trace_soft(js, jo, jd, tau=TAU, tau_z=TAU_Z, depth=0).stacked())
    sky = skip.max(-1)
    assert float(skip.min()) > 0.1 and float(np.ptp(skip, axis=(0, 1)).max()) < 1e-3
    dark_j = img_j.max(-1) < sky - 0.05
    assert dark_j.any() and not dark_j.all()
    np.testing.assert_array_equal(img_j[dark_j], 0.0)
    np.testing.assert_allclose(skip[~dark_j], img_j[~dark_j], atol=2e-4, rtol=2e-4)
    assert aimed.any() and not aimed.all()
    np.testing.assert_array_equal(keep.max(-1) < sky - 0.05, aimed)
    assert np.array_equal(keep[~aimed], skip[~aimed])
