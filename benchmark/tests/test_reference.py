"""The plain reference against the program's CPU path (the kernels' plain
PyTorch versions) at tiny frames: hard and soft frames, and the gradients
of a fit's loss."""

import json

import numpy as np
import pytest
import torch

from benchmark import harness, inputs
from benchmark.reference import common, hard, soft

rt = pytest.importorskip("raytracer_tpu_torch")


def _setup(n=16):
    cfg = json.loads((harness.BENCH_DIR / "configs" / "grid-64.json").read_text())
    cfg["scene"]["n"] = n
    arrays = inputs.scene_arrays(cfg)
    cam = {k: np.asarray(v, np.float32) for k, v in cfg["camera"].items()}
    return arrays, cam, rt.Scene.from_numpy(arrays, device="cpu"), rt.Camera.from_numpy(cam, "cpu")


def test_scene_arrays_are_the_programs_grid():
    for n in (16, 64):
        arrays, _, scene, _ = _setup(n)
        want = rt.models.scenes.grid_sphere_scene(n, device="cpu")
        for got, exp in zip(scene.tensors(), want.tensors()):
            assert torch.equal(got, exp)


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_hard_frame(depth):
    arrays, cam, scene, camera = _setup()
    got = rt.render(scene, camera, 48, 27, depth=depth, device="cpu")
    want = hard.render(common.to_tensors(arrays, "cpu"), common.to_tensors(cam, "cpu"), 48, 27,
                       depth, lanes=500)
    assert (got - want).abs().max() < 1e-5


def test_walk_cameras_render_alike():
    arrays, cam, scene, _ = _setup()
    walk = inputs.camera_walk(cam, [["right", 3, 0.1], ["yaw", 2, 0.01], ["forward", 2, 0.1]])
    for k in (0, 4, 6):
        c = inputs.camera_at(walk, k, 90.0)
        got = rt.render(scene, rt.Camera.from_numpy(c, "cpu"), 48, 27, depth=2, device="cpu")
        want = hard.render(common.to_tensors(arrays, "cpu"), common.to_tensors(c, "cpu"), 48, 27, 2)
        assert (got - want).abs().max() < 1e-5


def test_walk_is_the_viewers_key_actions():
    """The render cell's walk, camera by camera, as the viewer's keys move
    the program's camera: ``apply_action`` at its ``movement_speed`` and
    ``rotate_left_right`` for a turn."""
    from raytracer_tpu_torch.ops import camera_ops

    t = json.loads((harness.BENCH_DIR / "traffic" / "viewer-walk-4k-d4.json").read_text())
    _, cam, _, camera = _setup()
    walk = inputs.camera_walk(cam, t["walk"])
    assert len(walk) == 240
    k = 0
    for action, count, amount in t["walk"]:
        for _ in range(count):
            if action == "yaw":
                assert abs(amount) == 0.1  # the "," and "." keys
                camera = camera_ops.rotate_left_right(camera, amount)
            else:
                assert amount == pytest.approx(float(camera.movement_speed))
                camera = camera_ops.apply_action(camera, action)
            for got, want in ((camera.position, walk[k][0]), (camera.lookat, walk[k][1]),
                              (camera.vup, walk[k][2])):
                assert np.abs(got.numpy() - want).max() < 1e-4, (k, action)
            k += 1
    # A closed loop: the walk ends at the camera it starts from.
    assert np.abs(walk[-1] - np.stack([cam["position"], cam["lookat"], cam["vup"]])).max() < 1e-5


@pytest.mark.parametrize("depth", [0, 1])
@pytest.mark.parametrize("tau", [0.002, 0.01])
def test_soft_frame(depth, tau):
    arrays, cam, scene, camera = _setup()
    got = rt.render_soft(scene, camera, 48, 27, tau=tau, tau_z=0.05, depth=depth, device="cpu")
    want = soft.render(common.to_tensors(arrays, "cpu"), common.to_tensors(cam, "cpu"), 48, 27,
                       depth, tau, 0.05, lanes=400)
    assert (got - want).abs().max() < 1e-5


@pytest.mark.parametrize("kind", ["soft", "hard"])
def test_fit_gradients(kind):
    arrays, cam, scene, camera = _setup()
    target = hard.render(common.to_tensors(arrays, "cpu"), common.to_tensors(cam, "cpu"), 48, 27, 1)
    start = inputs.start_draw(arrays, 0.15, inputs.seeded_generator(7, "cpu"), "cpu")
    params = {k: v.clone().requires_grad_(True) for k, v in start.items()}
    full = rt.merge_params(scene, params)
    if kind == "soft":
        img = rt.render_soft(full, camera, 48, 27, tau=0.01, tau_z=0.05, depth=1, device="cpu")
    else:
        img = rt.render(full, camera, 48, 27, depth=1, device="cpu")
    loss = torch.mean((img - target) ** 2)
    loss.backward()
    mine = {k: v.clone().requires_grad_(True) for k, v in start.items()}
    args = (common.to_tensors(arrays, "cpu"), mine, common.to_tensors(cam, "cpu"), 48, 27, 1, target)
    if kind == "soft":
        want_loss, grads = soft.loss_and_grads(*args, tau=0.01, tau_z=0.05, lanes=500)
    else:
        want_loss, grads = hard.loss_and_grads(*args, lanes=500)
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-5 * float(want_loss)
    for k in params:
        scale = float(grads[k].abs().max())
        assert float((params[k].grad - grads[k]).abs().max()) <= 1e-4 * scale


def test_level_counts_add_up():
    arrays, cam, _, _ = _setup()
    stats = [{} for _ in range(3)]
    hard.render(common.to_tensors(arrays, "cpu"), common.to_tensors(cam, "cpu"), 48, 27, 2,
                stats=stats)
    assert stats[0]["alive"] == 48 * 27
    for lv in stats:
        assert lv["sphere"] + lv["wall"] + lv["miss"] == lv["alive"]
        assert lv["used"] <= lv["alive"]
