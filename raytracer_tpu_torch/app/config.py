"""Run configuration: a render, benchmark or fit workload as data.

``RenderConfig`` names a scene factory and its arguments, the frame size,
the reflection depth, the tone map, the closest-hit fold and the fit's
settings; ``BASELINE_CONFIGS`` holds the five benchmark workloads of
BASELINE.json and the reference renderer's own default frame, with the same
fields and values as the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from raytracer_tpu_torch.core.types import Camera, Scene
from raytracer_tpu_torch.models import scenes

__all__ = ["RenderConfig", "BASELINE_CONFIGS", "get_config"]


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """One render, benchmark or fit workload."""

    name: str
    scene: str  # a factory of models.scenes: demo, sprint3, grid, random, logo, mixed
    scene_args: dict = dataclasses.field(default_factory=dict)
    width: int = 640
    height: int = 640
    depth: int = 3  # reflection bounces
    tonemap: bool = True
    depth_only: bool = False
    fold: str = "auto"  # closest-hit fold, as render(fold=...) takes it: auto | jnp | pallas | pallas_flat
    # differentiable-fit settings (BASELINE config 4)
    fit: bool = False
    fit_steps: int = 200
    fit_lr: float = 2e-2
    # rank mesh: (px, prim), "auto" (every rank on the pixel axis when
    # more than one takes part), or None (one device)
    mesh: tuple[int, int] | str | None = None

    def build_mesh(self, device=None):
        """The ``parallel.mesh.Mesh`` of ``mesh``, or ``None`` for one device.

        Starts the process group from torchrun's environment first, if there
        is one (``initialize_distributed``). ``None`` gives ``None``.
        ``"auto"`` gives ``slice_mesh()`` over every rank when more than one
        takes part and ``None`` on one rank; a single process on a host of
        several CUDA devices raises (launch it under torchrun, one rank a
        device). ``(px, prim)`` gives ``slice_mesh(prim)`` and raises unless
        ``px * prim`` is the number of ranks. ``device`` (``None``: CUDA) is
        where this rank renders."""
        from raytracer_tpu_torch.parallel.hosts import initialize_distributed, slice_mesh

        if self.mesh is None:
            return None
        initialize_distributed(device=device)
        world = dist.get_world_size() if dist.is_initialized() else 1
        if self.mesh == "auto":
            if world > 1:
                return slice_mesh(device=device)
            cuda = torch.device("cuda" if device is None else device).type == "cuda"
            if cuda and not dist.is_initialized() and torch.cuda.device_count() > 1:
                raise RuntimeError(
                    f"mesh 'auto' on {torch.cuda.device_count()} CUDA devices in one "
                    "process: launch under torchrun (--nproc-per-node "
                    f"{torch.cuda.device_count()}), one rank a device"
                )
            return None
        px, prim = self.mesh
        if px * prim != world:
            raise ValueError(
                f"mesh {px}x{prim} needs {px * prim} ranks, and {world} take part: "
                f"launch {px * prim} ranks under torchrun"
            )
        return slice_mesh(prim, device=device)

    def build_scene(self, device=None) -> Scene:
        factory = {
            "demo": scenes.reference_demo_scene,
            "sprint3": scenes.sprint3_scene,
            "grid": scenes.grid_sphere_scene,
            "random": scenes.random_sphere_scene,
            "logo": scenes.logo_sphere_scene,
            "mixed": scenes.mixed_primitive_scene,
        }[self.scene]
        return factory(**self.scene_args, device=device)

    def build_camera(self, device=None) -> Camera:
        """The demo camera: every workload renders through it, as in the
        JAX package."""
        return scenes.reference_demo_camera(device=device)

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


# The five benchmark configurations of BASELINE.json, and the reference
# renderer's own default frame (ref-demo-640-d10).
BASELINE_CONFIGS: dict[str, RenderConfig] = {
    c.name: c
    for c in [
        RenderConfig(
            name="c1-depth-pass",
            scene="demo",
            width=320, height=240, depth=0, depth_only=True, tonemap=False,
        ),
        RenderConfig(
            name="c2-sprint3-1bounce",
            scene="sprint3",
            width=640, height=480, depth=1,
        ),
        RenderConfig(
            name="c3-1080p-3bounce",
            scene="sprint3",
            width=1920, height=1080, depth=3,
        ),
        RenderConfig(
            name="c4-fit-64sphere",
            scene="grid", scene_args={"n": 64},
            width=1920, height=1080, depth=1, fit=True,
        ),
        RenderConfig(
            # The reference's default frame: 640x640, depth 10, the demo scene.
            name="ref-demo-640-d10",
            scene="demo",
            width=640, height=640, depth=10,
        ),
        RenderConfig(
            # Pixel-row sharding over every rank when more than one takes
            # part (torchrun), one device otherwise.
            name="c5-4k-1024sphere",
            scene="grid", scene_args={"n": 1024},
            width=3840, height=2160, depth=4, mesh="auto",
        ),
    ]
}


def get_config(name: str, **overrides: Any) -> RenderConfig:
    cfg = BASELINE_CONFIGS[name]
    return cfg.replace(**overrides) if overrides else cfg
