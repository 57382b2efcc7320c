"""raytracer_tpu_torch: the ray tracer in PyTorch, with CUDA kernels for Hopper.

The hard renderer: camera rays, the mirror-bounce loop in one hand-written
CUDA kernel (``ops/cuda_fold.py``, ``csrc/trace_whole.cu``) and the Reinhard
tone map; its gradients through a second kernel, the whole-trace backward
(``csrc/trace_whole_bwd.cu``), behind a ``torch.autograd.Function``; large
scenes and deep traces through the per-level chain (``ops/cuda_level.py``:
``csrc/ray_stats.cu``, ``csrc/trace_level.cu``, ``csrc/trace_level_bwd.cu``);
the soft differentiable renderer for geometry fits (``diff/soft.py``:
``render_soft``, one soft level per launch of ``csrc/soft_level.cu``, its
backward ``csrc/soft_level_bwd.cu``, ``ops/cuda_soft.py``); and the fit step
(``parallel/train.py``, hard or soft). Entry points run on CUDA unless called
with ``device="cpu"``, which runs the kernels' plain PyTorch versions.
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
from raytracer_tpu_torch.diff.soft import render_soft, trace_soft
from raytracer_tpu_torch.parallel.train import default_params, make_fit_step, merge_params
from raytracer_tpu_torch.render.integrator import render, trace_rays

__all__ = [
    "render",
    "trace_rays",
    "render_soft",
    "trace_soft",
    "make_fit_step",
    "default_params",
    "merge_params",
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
