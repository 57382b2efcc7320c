"""raytracer_tpu_torch: the ray tracer in PyTorch, with CUDA kernels for Hopper.

The hard renderer: camera rays, the mirror-bounce loop in one hand-written
CUDA kernel (``ops/cuda_fold.py``, ``csrc/trace_whole.cu``) and the Reinhard
tone map; its gradients through a second kernel, the whole-trace backward
(``csrc/trace_whole_bwd.cu``), behind a ``torch.autograd.Function``; large
scenes and deep traces through the per-level chain (``ops/cuda_level.py``:
``csrc/ray_stats.cu``, ``csrc/trace_level.cu``, ``csrc/trace_level_bwd.cu``);
the soft differentiable renderer for geometry fits (``diff/soft.py``:
``render_soft``, one soft level per launch of ``csrc/soft_level.cu``, its
backward ``csrc/soft_level_bwd.cu``, ``ops/cuda_soft.py``); the closest-hit
API (``closest_hit_soa``, the depth pass ``render_depth`` and the fold
selectors of ``render(fold=...)``) through the fold kernels
``csrc/fold_shortlist.cu`` and ``csrc/fold_flat.cu`` (``ops/cuda_hit.py``);
the fit step (``parallel/train.py``, hard or soft); and distribution over
``torch.distributed`` ranks (``parallel/``: ``make_mesh``, the pixel-row and
sphere-axis sharded ``render_sharded``, the sharded soft render and the
meshed fit step; ``parallel/dryrun.py`` runs them in processes on one host).
The user's entry points: the run configurations (``app/config.py``:
``RenderConfig``, ``BASELINE_CONFIGS``), the fit app (``app/fit.py``:
``run_fit``, with ``utils/checkpoint.py``), the command line
(``app/cli.py``: ``render``, ``bench``, ``fit``, ``view``, ``configs``), the
terminal viewer (``app/viewer.py``, ``ops/camera_ops.py``, ``io/term.py``),
image files (``io/images.py``) and the phase timer and profiler trace
(``utils/profiler.py``). Entry points run on CUDA unless called with
``device="cpu"`` (``--device cpu`` on the command line), which runs the
kernels' plain PyTorch versions.
"""

from raytracer_tpu_torch.app.config import BASELINE_CONFIGS, RenderConfig, get_config
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
from raytracer_tpu_torch.parallel import make_mesh, render_sharded
from raytracer_tpu_torch.parallel.train import default_params, make_fit_step, merge_params
from raytracer_tpu_torch.ops.trace import closest_hit_soa
from raytracer_tpu_torch.render.integrator import render, render_depth, trace_rays

__all__ = [
    "RenderConfig",
    "BASELINE_CONFIGS",
    "get_config",
    "render",
    "render_depth",
    "closest_hit_soa",
    "trace_rays",
    "render_soft",
    "trace_soft",
    "make_mesh",
    "render_sharded",
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
