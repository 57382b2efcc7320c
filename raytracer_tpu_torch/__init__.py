"""raytracer_tpu_torch: the ray tracer in PyTorch, with CUDA kernels for Hopper.

The hard renderer's forward frame: camera rays, the mirror-bounce loop in one
hand-written CUDA kernel (``ops/cuda_fold.py``, ``csrc/trace_whole.cu``), and
the Reinhard tone map. Entry points run on CUDA unless called with
``device="cpu"``, which runs the kernel's plain PyTorch version.
"""

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
)
from raytracer_tpu_torch.core.v3 import V3
from raytracer_tpu_torch.render.integrator import render, trace_rays

__all__ = [
    "render",
    "trace_rays",
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
]
