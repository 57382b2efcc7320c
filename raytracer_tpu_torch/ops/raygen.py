"""Camera frame setup.

Deliberate deviations from the reference renderer (kept from the JAX
package): real pi, a float aspect ratio, and unit ray directions.
"""

from __future__ import annotations

import math

import torch

from raytracer_tpu_torch.core import math3
from raytracer_tpu_torch.core.types import Camera, CameraFrame

__all__ = ["camera_frame"]


def camera_frame(cam: Camera, width: int, height: int) -> CameraFrame:
    """Ray-generation anchors: focal length from the lookat distance, a
    vertical-FOV frustum, the (u, v, w) basis, and the world-space position
    of pixel (0, 0)'s center."""
    position, lookat, vup = cam.position, cam.lookat, cam.vup
    focal_length = math3.length(position - lookat)
    theta = cam.vfov * (math.pi / 180.0)
    fov_height = 2.0 * torch.tan(theta / 2.0) * focal_length
    fov_width = fov_height * (width / height)

    w = math3.normalize(position - lookat)
    u = math3.normalize(math3.cross(vup, w))
    v = math3.cross(w, u)

    fov_x = u * fov_width
    fov_y = v * (-fov_height)
    pixel_delta_x = fov_x / width
    pixel_delta_y = fov_y / height

    fov_top_left = position - w * focal_length - fov_x / 2.0 - fov_y / 2.0
    image_top_left = fov_top_left + (pixel_delta_x + pixel_delta_y) * 0.5
    return CameraFrame(position, image_top_left, pixel_delta_x, pixel_delta_y)
