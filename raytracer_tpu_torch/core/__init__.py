"""Core value types: component-SoA vectors and the scene/camera dataclasses."""

from raytracer_tpu_torch.core.types import (
    Boxes,
    Camera,
    CameraFrame,
    Lights,
    Materials,
    Scene,
    Sky,
    Spheres,
    Walls,
    resolve_device,
)
from raytracer_tpu_torch.core.v3 import V3

__all__ = [
    "V3",
    "Materials",
    "Spheres",
    "Walls",
    "Boxes",
    "Lights",
    "Sky",
    "Scene",
    "Camera",
    "CameraFrame",
    "resolve_device",
]
