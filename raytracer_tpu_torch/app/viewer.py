"""Terminal viewer: the reference renderer's main loop without a window.

Frames render continuously and show as ANSI truecolor half-blocks
(io/term.py). WASD and the arrow keys move the camera, ``,``/``.`` yaw,
``[``/``]`` pitch, ``r`` resets the camera and ``q`` quits; the phase
averages (``raytracing``, ``present``) print on exit and, with
``log_path``, are written to a ``.log`` file with every frame's samples.
With ``max_frames`` set, or stdin not a terminal, the loop runs without
reading keys.
"""

from __future__ import annotations

import select
import sys

import numpy as np
import torch

from raytracer_tpu_torch.app.config import RenderConfig
from raytracer_tpu_torch.core.types import resolve_device
from raytracer_tpu_torch.io import term_frame
from raytracer_tpu_torch.ops.camera_ops import apply_action, rotate_left_right, rotate_up_down
from raytracer_tpu_torch.render.integrator import render
from raytracer_tpu_torch.utils.profiler import PhaseTimer

__all__ = ["run_viewer", "test_pattern_frame"]

_KEY_ACTIONS = {
    "w": "forward", "s": "backward", "a": "left", "d": "right",
    # arrow keys arrive as ESC [ A/B/C/D; decoded in _read_key
    "UP": "forward", "DOWN": "backward", "LEFT": "left", "RIGHT": "right",
}


def _read_key(timeout: float) -> str | None:
    """One key from stdin (cbreak mode), arrow escapes decoded; None when idle."""
    r, _, _ = select.select([sys.stdin], [], [], timeout)
    if not r:
        return None
    ch = sys.stdin.read(1)
    if ch == "\x1b":
        seq = sys.stdin.read(2) if select.select([sys.stdin], [], [], 0.01)[0] else ""
        return {"[A": "UP", "[B": "DOWN", "[C": "RIGHT", "[D": "LEFT"}.get(seq)
    return ch


def test_pattern_frame(width: int, height: int) -> np.ndarray:
    """The reference's debug gradient: red 1, green x / width, blue
    y / height."""
    x = np.linspace(0.0, 1.0, width, endpoint=False, dtype=np.float32)
    y = np.linspace(0.0, 1.0, height, endpoint=False, dtype=np.float32)
    img = np.empty((height, width, 3), np.float32)
    img[..., 0] = 1.0
    img[..., 1] = x[None, :]
    img[..., 2] = y[:, None]
    return img


def run_viewer(cfg: RenderConfig, *, max_cols: int = 100, max_frames: int = 0,
               log_path=None, test_pattern: bool = False, device=None) -> int:
    """Render ``cfg`` frame after frame into the terminal on ``device``
    (``None``: CUDA) until ``q``, or for ``max_frames`` frames."""
    dev = resolve_device(device)
    scene = cfg.build_scene(device=dev)
    camera0 = camera = cfg.build_camera(device=dev)
    timer = PhaseTimer()

    def frame(cam) -> np.ndarray:
        if test_pattern:
            return test_pattern_frame(cfg.width, cfg.height)
        with torch.no_grad():
            img = render(scene, cam, cfg.width, cfg.height, depth=cfg.depth,
                         tonemap=cfg.tonemap, fold=cfg.fold, device=dev)
        return img.cpu().numpy()

    interactive = sys.stdin.isatty() and max_frames == 0
    saved_tty = None
    if interactive:
        import termios
        import tty

        saved_tty = termios.tcgetattr(sys.stdin.fileno())
        tty.setcbreak(sys.stdin.fileno())

    frames = 0
    print("\x1b[2J", end="")  # clear
    try:
        while True:
            with timer.phase("raytracing"):
                img = frame(camera)
            with timer.phase("present"):
                sys.stdout.write("\x1b[H" + term_frame(img, max_width=max_cols))
                sys.stdout.flush()
            frames += 1
            if max_frames and frames >= max_frames:
                break
            if not interactive:
                continue  # no keys to read (piped or scripted runs)
            key = _read_key(0.01)
            if key == "q":
                break
            if key == "r":
                camera = camera0
            elif key in _KEY_ACTIONS:
                camera = apply_action(camera, _KEY_ACTIONS[key])
            elif key == ",":
                camera = rotate_left_right(camera, 0.1)
            elif key == ".":
                camera = rotate_left_right(camera, -0.1)
            elif key == "[":
                camera = rotate_up_down(camera, 0.1)
            elif key == "]":
                camera = rotate_up_down(camera, -0.1)
    except KeyboardInterrupt:
        pass
    finally:
        if saved_tty is not None:
            import termios

            termios.tcsetattr(sys.stdin.fileno(), termios.TCSADRAIN, saved_tty)
        print("\n" + timer.report())
        if log_path:
            timer.save(log_path)
    return 0
