"""The port's app layer on the CPU against the JAX package's: the run
configurations, the two scene factories it adds, PNG and PPM files, the
terminal frame, the camera moves, the command line's render, depth pass,
view, configs and bench, the phase timer and the profiler trace."""

import dataclasses
import json
import struct
import zlib

import numpy as np
import pytest
import torch

from raytracer_tpu.app.cli import main as j_main
from raytracer_tpu.app.config import BASELINE_CONFIGS as J_CONFIGS
from raytracer_tpu.core.types import Camera as JCamera
from raytracer_tpu.io import images as j_images
from raytracer_tpu.io.term import term_frame as j_term_frame
from raytracer_tpu.models import scenes as jscenes
from raytracer_tpu.ops import camera_ops as j_camera_ops
from raytracer_tpu.oracle.numpy_ref import scene_to_numpy
from raytracer_tpu.utils.profiler import PhaseTimer as JPhaseTimer
from raytracer_tpu_torch.app.cli import depth_image, main
from raytracer_tpu_torch.app.config import BASELINE_CONFIGS
from raytracer_tpu_torch.core.types import Camera, Scene
from raytracer_tpu_torch.io import load_image, save_png, save_ppm, term_frame, to_u8
from raytracer_tpu_torch.models import scenes as tscenes
from raytracer_tpu_torch.ops import camera_ops
from raytracer_tpu_torch.render.integrator import render, render_depth
from raytracer_tpu_torch.utils.profiler import PhaseTimer, trace_capture

torch.set_num_threads(1)

SMALL = ["--device", "cpu", "--width", "48", "--height", "36"]


def _image(h=37, w=53, seed=0) -> np.ndarray:
    """A seeded float image with values outside [0, 1] to clamp."""
    return np.random.default_rng(seed).uniform(-0.1, 1.1, (h, w, 3)).astype(np.float32)


def test_configs_equal_jax_field_for_field():
    assert list(BASELINE_CONFIGS) == list(J_CONFIGS)
    for name, cfg in BASELINE_CONFIGS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(J_CONFIGS[name]), name
    # One process, no CUDA here: "auto" is one device; a (2, 1) mesh needs
    # two ranks and says so.
    assert BASELINE_CONFIGS["c5-4k-1024sphere"].build_mesh() is None
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 ranks.*torchrun"):
        BASELINE_CONFIGS["c3-1080p-3bounce"].replace(mesh=(2, 1)).build_mesh(device="cpu")


@pytest.mark.parametrize("name", ["random", "logo"])
def test_new_scene_factories_equal_jax(name):
    """``random_sphere_scene(37, seed=3)`` (Morton-sorted) and
    ``logo_sphere_scene()`` hold the JAX factories' float32 values exactly."""
    if name == "random":
        got, want = (tscenes.random_sphere_scene(37, seed=3, device="cpu"),
                     jscenes.random_sphere_scene(37, seed=3))
    else:
        got, want = tscenes.logo_sphere_scene(device="cpu"), jscenes.logo_sphere_scene()
    ref = Scene.from_numpy(scene_to_numpy(want, np.float32), device="cpu")
    for a, b in zip(got.tensors(), ref.tensors(), strict=True):
        assert a.dtype == torch.float32 and torch.equal(a, b)


def _png_with_filters(a: np.ndarray) -> bytes:
    """An 8-bit PNG of ``a`` ([H, W, 3] or [H, W, 4] u8) whose row y uses
    filter y % 5, encoded here from the PNG specification."""
    h, w, c = a.shape
    rows = a.reshape(h, w * c).astype(np.int64)
    out = []
    for y in range(h):
        cur, up = rows[y], rows[y - 1] if y else np.zeros(w * c, np.int64)
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        kind = y % 5
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) // 2
        else:
            p = left + up - upleft
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        out.append(bytes([kind]) + ((cur - pred) % 256).astype(np.uint8).tobytes())

    def chunk(kind, payload):
        return struct.pack(">I", len(payload)) + kind + payload + struct.pack(
            ">I", zlib.crc32(kind + payload))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


def test_png_and_ppm_match_jax(tmp_path):
    """The port's PNG and PPM of a seeded image decode, through the JAX
    package's ``load_image``, to the u8 pixels of the JAX package's own
    files; the port's ``load_image`` reads both back, and reads RGB and
    RGBA PNGs that use all five row filters (alpha dropped)."""
    img = _image()
    want = j_images.to_u8(img)
    assert np.array_equal(to_u8(img), want)
    assert np.array_equal(to_u8(torch.from_numpy(img)), want)
    for ext, port_save, jax_save in (("png", save_png, j_images.save_png),
                                     ("ppm", save_ppm, j_images.save_ppm)):
        ours, theirs = tmp_path / f"port.{ext}", tmp_path / f"jax.{ext}"
        port_save(ours, torch.from_numpy(img))
        jax_save(theirs, img)
        assert np.array_equal(j_images.load_image(ours), j_images.load_image(theirs))
        assert np.array_equal(j_images.load_image(ours), want)
        assert np.array_equal(load_image(ours), want)
        assert np.array_equal(load_image(theirs), want)
    rgba = np.random.default_rng(1).integers(0, 256, (11, 7, 4), dtype=np.uint8)
    for a in (want, rgba):
        path = tmp_path / f"filters{a.shape[2]}.png"
        path.write_bytes(_png_with_filters(a))
        assert np.array_equal(load_image(path), a[..., :3])
        assert np.array_equal(load_image(path), j_images.load_image(path))


def test_term_frame_matches_jax_byte_for_byte():
    """An odd height (the last text row is half a block), and a frame past
    ``max_width`` (the nearest-neighbour downscale)."""
    img = _image(37, 53, seed=2)
    for cols in (120, 20):
        want = j_term_frame(img, max_width=cols)
        assert term_frame(img, max_width=cols) == want
        assert term_frame(torch.from_numpy(img), max_width=cols) == want


def test_camera_moves_match_jax():
    """A sequence of moves and rotations, 20 pitch steps up (those past
    pi/2 rejected) and one past -pi/2, gives the JAX cameras to 1e-6: the
    same float32 formulas, whose rsqrt and atan2 may differ in the last
    bit between the two libraries."""
    jc, tc = JCamera.create(), Camera.create()
    steps = [("act", "forward"), ("act", "right"), ("yaw", 0.3), ("act", "left"),
             ("pitch", -0.2), ("act", "backward"), ("yaw", -1.1), ("speed", 0.5)]
    steps += [("pitch", 0.1)] * 20 + [("pitch", -3.3), ("act", "forward")]
    for kind, arg in steps:
        if kind == "act":
            jc, tc = j_camera_ops.apply_action(jc, arg), camera_ops.apply_action(tc, arg)
        elif kind == "speed":
            jc = j_camera_ops.apply_action(jc, "forward", speed=arg)
            tc = camera_ops.apply_action(tc, "forward", speed=arg)
        elif kind == "yaw":
            jc, tc = j_camera_ops.rotate_left_right(jc, arg), camera_ops.rotate_left_right(tc, arg)
        else:
            jc, tc = j_camera_ops.rotate_up_down(jc, arg), camera_ops.rotate_up_down(tc, arg)
        for f in ("position", "lookat", "vup"):
            np.testing.assert_allclose(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)),
                                       atol=1e-6, err_msg=f"{kind} {arg} {f}")
    with pytest.raises(ValueError):
        camera_ops.apply_action(tc, "up")


def test_cli_render_and_depth_pass_on_cpu(tmp_path):
    """``render`` writes the PNG of ``to_u8(render(...))`` exactly;
    ``render --depth-only`` the normalised depth of ``render_depth`` (near
    1, misses 0), the JAX CLI's normalisation."""
    out = tmp_path / "f.png"
    assert main(["render", "--scene", "demo", "--depth", "1", *SMALL, "-o", str(out)]) == 0
    scene, cam = tscenes.reference_demo_scene(device="cpu"), tscenes.reference_demo_camera("cpu")
    with torch.no_grad():
        want = render(scene, cam, 48, 36, depth=1, device="cpu")
    assert np.array_equal(load_image(out), to_u8(want))

    out = tmp_path / "d.png"
    assert main(["render", "--config", "c1-depth-pass", *SMALL, "--depth-only", "-o",
                 str(out)]) == 0
    depth = render_depth(scene, cam, 48, 36, device="cpu").numpy()
    viz = depth_image(depth)
    assert np.isfinite(depth).any() and np.isfinite(viz).all()
    assert viz.max() == 1.0 and viz.min() == 0.0  # the nearest hit, and misses
    assert np.array_equal(load_image(out), to_u8(viz))


def test_cli_configs_bench_and_mesh(capsys, monkeypatch, tmp_path):
    """``configs`` prints the JAX CLI's text; ``bench`` times only on the
    card and raises on ``--device cpu`` even where a card is present, and
    on the default device where none is; ``--mesh 2,1`` in one process
    raises (it needs two ranks under torchrun), and ``--mesh 1,1`` renders
    through ``render_sharded`` the PNG of ``render``."""
    assert main(["configs"]) == 0
    ours = capsys.readouterr().out
    assert j_main(["configs"]) == 0
    assert ours == capsys.readouterr().out
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        main(["bench", "--scene", "demo", "--width", "48", "--height", "36", "--iters", "2"])
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        with pytest.raises(RuntimeError, match="needs a CUDA device, not 'cpu'"):
            main(["bench", "--scene", "demo", *SMALL, "--iters", "2"])
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 ranks.*torchrun"):
        main(["render", "--scene", "demo", *SMALL, "--mesh", "2,1", "-o", "unused.png"])
    out = tmp_path / "mesh.png"
    assert main(["render", "--scene", "demo", "--depth", "2", *SMALL, "--mesh", "1,1", "-o",
                 str(out)]) == 0
    assert "mesh=1x1" in capsys.readouterr().out
    with torch.no_grad():
        want = render(tscenes.reference_demo_scene(device="cpu"),
                      tscenes.reference_demo_camera(device="cpu"), 48, 36, depth=2, device="cpu")
    assert np.array_equal(load_image(out), to_u8(want))


def test_cli_view_and_phase_timer(tmp_path, capsys):
    """``view --frames 2`` presents two frames and reports both phases;
    with ``--test-pattern`` the red channel is pinned at 255. ``PhaseTimer``
    reports and saves as the JAX package's does."""
    log = tmp_path / "view.log"
    assert main(["view", "--scene", "demo", "--depth", "1", *SMALL, "--frames", "2",
                 "--max-cols", "32", "--log", str(log)]) == 0
    out = capsys.readouterr().out
    assert out.count("\x1b[H") == 2 and "\x1b[38;2;" in out
    assert "average raytracing time" in out and "average present time" in out
    text = log.read_text()
    assert "# raytracing per-frame seconds" in text and "average present time" in text
    assert main(["--device", "cpu", "view", "--scene", "demo", "--width", "48", "--height",
                 "36", "--frames", "1", "--max-cols", "32", "--test-pattern"]) == 0
    assert "\x1b[38;2;255;" in capsys.readouterr().out

    ours, theirs = PhaseTimer(), JPhaseTimer()
    for t in (ours, theirs):
        t.record("render", 0.002)
        t.record("render", 0.004)
        t.record("present", 0.0005)
    assert ours.report() == theirs.report()
    ours.save(tmp_path / "a.log")
    theirs.save(tmp_path / "b.log")
    assert (tmp_path / "a.log").read_text() == (tmp_path / "b.log").read_text()


def test_trace_capture_writes_chrome_trace(tmp_path):
    """``trace_capture`` on the CPU writes ``trace.json`` holding the
    block's host ops; ``None`` is a no-op."""
    with trace_capture(None, device="cpu"):
        pass
    with trace_capture(tmp_path / "t", device="cpu"):
        torch.ones(8).add_(1.0)
    trace = json.loads((tmp_path / "t" / "trace.json").read_text())
    assert any("add" in ev.get("name", "") for ev in trace["traceEvents"])
