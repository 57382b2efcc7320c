"""The port's scenes, camera, ray generation and tone map against the JAX
package, and the port's import and build guards. CPU only."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracer_tpu.models import scenes as jscenes
from raytracer_tpu.ops.raygen import camera_frame as j_camera_frame
from raytracer_tpu.ops.tonemap import reinhard_tonemap as j_tonemap
from raytracer_tpu.ops.trace import raygen_tile as j_raygen_tile
from raytracer_tpu.oracle.numpy_ref import scene_to_numpy
from raytracer_tpu.core.types import Camera as JCamera
from raytracer_tpu_torch.core.types import Camera, Scene
from raytracer_tpu_torch.models import scenes as tscenes
from raytracer_tpu_torch.ops import _build
from raytracer_tpu_torch.ops.raygen import camera_frame
from raytracer_tpu_torch.ops.tonemap import reinhard_tonemap, to_uint8
from raytracer_tpu_torch.ops.trace import raygen_tile

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

SCENES = {
    "demo": (jscenes.reference_demo_scene, tscenes.reference_demo_scene),
    "sprint3": (jscenes.sprint3_scene, tscenes.sprint3_scene),
    "grid64": (lambda: jscenes.grid_sphere_scene(64), lambda device: tscenes.grid_sphere_scene(64, device=device)),
    "grid10_seed3": (
        lambda: jscenes.grid_sphere_scene(10, seed=3, distance=6.0),
        lambda device: tscenes.grid_sphere_scene(10, seed=3, distance=6.0, device=device),
    ),
    "mixed": (jscenes.mixed_primitive_scene, tscenes.mixed_primitive_scene),
    "mixed_no_sun": (
        lambda: jscenes.mixed_primitive_scene(sun=False),
        lambda device: tscenes.mixed_primitive_scene(sun=False, device=device),
    ),
}

CAMERAS = {
    "demo": jscenes.reference_demo_camera(),
    "oblique": JCamera.create(
        position=(1.0, 2.0, -0.5), lookat=(6.0, -1.0, 0.5), vup=(0.0, 0.0, 1.0),
        vfov=55.0,
    ),
}


def _camera_from_jax(cam) -> Camera:
    return Camera.from_numpy(
        {f: np.asarray(getattr(cam, f)) for f in
         ("position", "lookat", "vup", "vfov", "movement_speed")},
        device="cpu",
    )


@pytest.mark.parametrize("name", list(SCENES))
def test_scene_factories_bit_identical(name):
    jmake, tmake = SCENES[name]
    want = Scene.from_numpy(scene_to_numpy(jmake(), np.float32), device="cpu")
    got = tmake(device="cpu")
    leaves = list(zip(want.tensors(), got.tensors()))
    assert len(leaves) == 34
    for i, (a, b) in enumerate(leaves):
        assert a.dtype == b.dtype == torch.float32
        assert a.shape == b.shape and torch.equal(a, b), f"leaf {i}"


def test_camera_factory_bit_identical():
    want = _camera_from_jax(jscenes.reference_demo_camera())
    got = tscenes.reference_demo_camera(device="cpu")
    for a, b in zip(want.tensors(), got.tensors()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cam_name", list(CAMERAS))
@pytest.mark.parametrize("size", [(128, 64), (1920, 1080)])
def test_camera_frame_and_raygen_match_jax(cam_name, size):
    jcam = CAMERAS[cam_name]
    cam = _camera_from_jax(jcam)
    w, h = size
    jf, tf = j_camera_frame(jcam, w, h), camera_frame(cam, w, h)
    for field in ("origin", "image_top_left", "pixel_delta_x", "pixel_delta_y"):
        np.testing.assert_allclose(
            getattr(tf, field).numpy(), np.asarray(getattr(jf, field)), rtol=0, atol=1e-6
        )
    rows, r0 = 16, h // 2
    (jo, jd), (to, td) = (
        j_raygen_tile(jcam, w, h, row_offset=r0, rows=rows),
        raygen_tile(cam, w, h, row_offset=r0, rows=rows),
    )
    for a, b in zip((*jo, *jd), (*to, *td)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-6)
    assert td.x.shape == (rows, w)


def test_tonemap_matches_jax():
    rgb = np.random.default_rng(0).gamma(0.7, 1.5, size=(32, 48, 3)).astype(np.float32)
    rgb[0, 0] = 0.0
    got = reinhard_tonemap(torch.from_numpy(rgb)).numpy()
    np.testing.assert_allclose(got, np.asarray(j_tonemap(jnp.asarray(rgb))), rtol=0, atol=1e-6)
    u8 = to_uint8(torch.tensor([[-0.5, 0.0, 0.5, 1.0, 2.0]]))
    assert u8.tolist() == [[0, 0, 128, 255, 255]]


def test_factories_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tscenes.sprint3_scene()
    with pytest.raises(RuntimeError, match="CUDA"):
        Scene.from_numpy(scene_to_numpy(jscenes.sprint3_scene(), np.float32))


def test_import_pulls_in_no_jax():
    code = (
        "import sys, raytracer_tpu_torch\n"
        "import raytracer_tpu_torch.utils.profiler, raytracer_tpu_torch.ops.cuda_fold\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib')"
        " or m == 'raytracer_tpu' or m.startswith('raytracer_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stdout + res.stderr


_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|raytracer_tpu)(?:\.|\s|$|,)", re.MULTILINE
)


def test_no_source_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "raytracer_tpu_torch").rglob("*")) + [ROOT / "chip_smoke.py"]
    files = [f for f in files if f.is_file() and f.suffix in (".py", ".cu", ".cuh")]
    assert len(files) > 10
    for f in files:
        hits = _FORBIDDEN.findall(f.read_text())
        assert not hits, f"{f.relative_to(ROOT)} imports {hits}"
    assert _FORBIDDEN.search("from raytracer_tpu.ops import x")
    assert _FORBIDDEN.search("import jax")
    assert not _FORBIDDEN.search("from raytracer_tpu_torch import render")


def test_build_command_targets_hopper_without_fast_math():
    cmd = _build.build_command(Path("k.cu"), Path("k.so"))
    line = " ".join(cmd)
    assert "compute_90a,code=sm_90a" in line
    assert "-fmad=false" in cmd
    assert "--use_fast_math" not in line and "-use_fast_math" not in line
    assert _build.BUILD_DIR == ROOT / "build" / "kernels"
    assert (_build.CSRC / "trace_whole.cu").is_file()
