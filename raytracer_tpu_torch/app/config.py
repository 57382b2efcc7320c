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
    # device mesh: (px, prim), "auto" (every local device on the pixel
    # axis when more than one is present), or None (one device)
    mesh: tuple[int, int] | str | None = None

    def build_mesh(self):
        """The mesh of ``mesh``: ``None`` on one device. ``None`` gives
        ``None``, and so does ``"auto"`` with at most one CUDA device;
        anything else needs the pixel-sharded path, which is not ported yet
        and raises."""
        if self.mesh is None:
            return None
        if self.mesh == "auto" and torch.cuda.device_count() <= 1:
            return None
        raise NotImplementedError(
            f"mesh {self.mesh!r} ({torch.cuda.device_count()} CUDA devices): the "
            "pixel-sharded path is not ported yet (ROADMAP queue 1, item 9)"
        )

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
            # Pixel-tile sharding over every local device when more than one
            # is present, one device otherwise.
            name="c5-4k-1024sphere",
            scene="grid", scene_args={"n": 1024},
            width=3840, height=2160, depth=4, mesh="auto",
        ),
    ]
}


def get_config(name: str, **overrides: Any) -> RenderConfig:
    cfg = BASELINE_CONFIGS[name]
    return cfg.replace(**overrides) if overrides else cfg
