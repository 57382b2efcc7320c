"""The port's ``render`` on the CPU (the kernel's plain version) against the
NumPy oracle and the JAX package's ``render``, plus its row chunking,
supersampling and batch-of-rays API."""

import numpy as np
import pytest
import torch

from raytracer_tpu.models import scenes as jscenes
from raytracer_tpu.oracle import numpy_ref
from raytracer_tpu.oracle.numpy_ref import scene_to_numpy
from raytracer_tpu.render import integrator as jintegrator
from raytracer_tpu_torch import render, trace_rays
from raytracer_tpu_torch.core.types import Scene
from raytracer_tpu_torch.models import scenes as tscenes
from raytracer_tpu_torch.ops.tonemap import reinhard_tonemap
from raytracer_tpu_torch.ops.trace import raygen_tile

torch.set_num_threads(1)


@pytest.mark.parametrize(
    "jmake, tmake, w, h, depth",
    [
        (jscenes.sprint3_scene, tscenes.sprint3_scene, 96, 64, 3),
        (jscenes.reference_demo_scene, tscenes.reference_demo_scene, 64, 64, 10),
    ],
    ids=["sprint3_96x64_d3", "demo_64x64_d10"],
)
def test_render_matches_oracle(jmake, tmake, w, h, depth):
    cam = jscenes.reference_demo_camera()
    img = render(
        tmake(device="cpu"), tscenes.reference_demo_camera(device="cpu"), w, h,
        depth=depth, device="cpu",
    ).numpy()
    want = numpy_ref.render_oracle(jmake(), cam, w, h, depth=depth, dtype=np.float32)
    assert img.shape == (h, w, 3) and np.isfinite(img).all()
    close = np.isclose(img, want, rtol=1e-4, atol=1e-4)
    assert close.mean() >= 0.999, f"{close.mean():.5f} close to the f32 oracle"


def test_render_matches_jax_render():
    """Within 5e-4 of the JAX render (its jnp path) everywhere but at sphere
    silhouettes: there the two normalise the camera rays with float32
    rsqrts that differ in the last bit (XLA's is approximate), which flips a
    few hit/miss decisions; at each such pixel the port must agree with the
    float64 oracle instead."""
    jscene, jcam = jscenes.sprint3_scene(), jscenes.reference_demo_camera()
    want = np.asarray(jintegrator.render(jscene, jcam, 96, 60, depth=2))
    got = render(
        Scene.from_numpy(scene_to_numpy(jscene, np.float32), device="cpu"),
        tscenes.reference_demo_camera(device="cpu"), 96, 60, depth=2, device="cpu",
    ).numpy()
    off = ~np.isclose(got, want, rtol=5e-4, atol=5e-4).all(axis=-1)
    assert off.mean() <= 2e-3, f"{off.sum()} pixels differ"
    exact = numpy_ref.render_oracle(jscene, jcam, 96, 60, depth=2, dtype=np.float64)
    np.testing.assert_allclose(got[off], exact[off], rtol=0, atol=1e-3)


def _scene_cam():
    return tscenes.grid_sphere_scene(20, distance=6.0, device="cpu"), tscenes.reference_demo_camera(device="cpu")


def test_row_chunks_equal_one_chunk():
    scene, cam = _scene_cam()
    full = render(scene, cam, 48, 40, depth=2, device="cpu")
    for row_chunk in (7, 16):
        chunked = render(scene, cam, 48, 40, depth=2, row_chunk=row_chunk, device="cpu")
        assert torch.equal(chunked, full)


def test_supersample_box_filters_the_fine_render():
    scene, cam = _scene_cam()
    fine = render(scene, cam, 48, 40, depth=2, tonemap=False, device="cpu")
    want = reinhard_tonemap(fine.reshape(20, 2, 24, 2, 3).mean(dim=(1, 3)))
    for row_chunk in (0, 5):
        got = render(scene, cam, 24, 20, depth=2, supersample=2, row_chunk=row_chunk, device="cpu")
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_trace_rays_matches_render_radiance():
    scene, cam = _scene_cam()
    o, d = raygen_tile(cam, 24, 8)
    dirs = d.stacked().reshape(-1, 3)
    origins = o.stacked().expand(dirs.shape)
    rad = trace_rays(scene, origins, dirs, depth=2, device="cpu")
    img = render(scene, cam, 24, 8, depth=2, tonemap=False, device="cpu")
    assert rad.shape == (24 * 8, 3)
    torch.testing.assert_close(rad, img.reshape(-1, 3), rtol=0, atol=0)


def test_entry_points_default_to_cuda(monkeypatch):
    """Without ``device`` the entry points run on CUDA, and raise without it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene, cam = _scene_cam()
    with pytest.raises(RuntimeError, match="CUDA"):
        render(scene, cam, 8, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        trace_rays(scene, torch.zeros(4, 3), torch.ones(4, 3))
