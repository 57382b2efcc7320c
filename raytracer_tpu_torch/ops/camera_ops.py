"""Camera movement and rotation: each move returns a new ``Camera``.

Moves translate the position and the look-at point together along the
look vector ``lookat - position`` (forward, backward) or along
``cross(look, vup)`` (right, left), by ``speed`` or the camera's own
``movement_speed``. Yaw rotates the look vector's xy component about z;
pitch sets its angle above the xy plane and rejects a step past +-pi/2,
keeping the previous pitch (and, past -pi/2, its negation), as the
reference renderer does. After either rotation ``vup`` is reset to the
recomputed up vector. The arithmetic is the JAX package's
``ops/camera_ops.py``.
"""

from __future__ import annotations

import math

import torch

from raytracer_tpu_torch.core import math3
from raytracer_tpu_torch.core.types import Camera

__all__ = [
    "move_forward",
    "move_backward",
    "move_left",
    "move_right",
    "rotate_left_right",
    "rotate_up_down",
    "apply_action",
]


def _speed(cam: Camera, speed):
    return cam.movement_speed if speed is None else speed


def _look(cam: Camera) -> torch.Tensor:
    return cam.lookat - cam.position


def _translate(cam: Camera, delta: torch.Tensor) -> Camera:
    return cam.replace(position=cam.position + delta, lookat=cam.lookat + delta)


def move_forward(cam: Camera, speed: float | None = None) -> Camera:
    return _translate(cam, math3.normalize(_look(cam)) * _speed(cam, speed))


def move_backward(cam: Camera, speed: float | None = None) -> Camera:
    return _translate(cam, -math3.normalize(_look(cam)) * _speed(cam, speed))


def _right_vec(cam: Camera) -> torch.Tensor:
    return math3.normalize(math3.cross(_look(cam), cam.vup))


def move_right(cam: Camera, speed: float | None = None) -> Camera:
    return _translate(cam, _right_vec(cam) * _speed(cam, speed))


def move_left(cam: Camera, speed: float | None = None) -> Camera:
    return _translate(cam, -_right_vec(cam) * _speed(cam, speed))


def _set_look(cam: Camera, new_dir: torch.Tensor) -> Camera:
    """Point the camera along ``new_dir`` with ``vup`` reset to the up
    vector it makes."""
    vup = math3.normalize(math3.cross(math3.cross(new_dir, cam.vup), new_dir))
    return cam.replace(lookat=cam.position + new_dir, vup=vup)


def rotate_left_right(cam: Camera, angle) -> Camera:
    """Yaw by ``angle`` radians about z."""
    d = _look(cam)
    base = torch.sqrt(d[0] ** 2 + d[1] ** 2)
    new = torch.atan2(d[1], d[0]) + angle
    return _set_look(cam, torch.stack([torch.cos(new) * base, torch.sin(new) * base, d[2]]))


def rotate_up_down(cam: Camera, angle) -> Camera:
    """Pitch by ``angle`` radians, rejecting steps past +-pi/2."""
    d = _look(cam)
    base = torch.sqrt(d[0] ** 2 + d[1] ** 2)
    pitch = torch.atan2(d[2], base)
    new = pitch + angle
    new = torch.where(new > math.pi / 2, pitch, new)
    new = torch.where(new < -math.pi / 2, -pitch, new)
    r = math3.length(d)
    xy = math3.normalize(torch.stack([d[0], d[1], torch.zeros_like(d[0])]))
    up = torch.tensor([0.0, 0.0, 1.0], dtype=d.dtype, device=d.device)
    return _set_look(cam, xy * (torch.cos(new) * r) + up * (torch.sin(new) * r))


_ACTIONS = {
    "forward": move_forward,  # W / Up
    "backward": move_backward,  # S / Down
    "left": move_left,  # A / Left
    "right": move_right,  # D / Right
}


def apply_action(cam: Camera, action: str, speed: float | None = None) -> Camera:
    """One keyboard move: ``forward``, ``backward``, ``left`` or ``right``."""
    try:
        return _ACTIONS[action](cam, speed)
    except KeyError:
        raise ValueError(f"unknown camera action {action!r}") from None
