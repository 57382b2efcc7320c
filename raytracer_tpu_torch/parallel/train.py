"""The differentiable-rendering fit step.

Fit scene leaves (by default the sphere centers and colours) to a target
image by Adam on the image MSE: one render with gradients, one backward and
one update per step. The hard renderer (``render``: its forward kernels with
residuals, then their backward kernels) has no gradient at silhouettes;
geometry fits take the soft one (``soft=True``: ``render_soft``, the soft
level kernels and their backward). The pixel-sharded mesh is not ported
yet and raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from raytracer_tpu_torch.core.types import Camera, Scene
from raytracer_tpu_torch.diff.soft import render_soft
from raytracer_tpu_torch.render.integrator import render

__all__ = ["FitState", "make_fit_step", "default_params", "merge_params"]


@dataclasses.dataclass
class FitState:
    """Parameters, their optimizer and the step count of a fit.

    ``params`` maps names to leaf tensors that require grad; ``optimizer``
    updates them in place (a step returns the same tensors, not new ones).
    """

    params: dict
    optimizer: torch.optim.Optimizer
    step: int


def default_params(scene: Scene) -> dict:
    """The standard fit parameterization: sphere centers and colours."""
    return {
        "center": scene.spheres.center,
        "color": scene.spheres.material.color,
    }


def merge_params(scene: Scene, params: dict) -> Scene:
    """The scene with the fit parameters written into it."""
    spheres = scene.spheres
    if "center" in params:
        spheres = spheres.replace(center=params["center"])
    if "color" in params:
        spheres = spheres.replace(
            material=spheres.material.replace(color=params["color"])
        )
    if "radius" in params:
        spheres = spheres.replace(radius=params["radius"])
    return scene.replace(spheres=spheres)


def make_fit_step(
    width: int,
    height: int,
    *,
    mesh: Any = None,
    depth: int = 1,
    learning_rate: float = 2e-2,
    tonemap: bool = True,
    device=None,
    soft: bool = False,
    soft_tau: float = 0.01,
    soft_tau_z: float = 0.05,
    optimizer: Callable[[dict], torch.optim.Optimizer] | None = None,
    merge: Callable[[Scene, dict], Scene] = merge_params,
    params_fn: Callable[[Scene], dict] = default_params,
) -> tuple[Callable, Callable]:
    """Build ``(init_fn, step_fn)`` for the differentiable fit.

    ``init_fn(scene) -> FitState`` copies ``params_fn(scene)`` (by default
    ``default_params``: the sphere centres and colours) into leaves that
    require grad, with ``optimizer(params)`` (the counterpart of the JAX
    package's ``optimizer`` option: a function of the parameter dict, e.g.
    for a learning rate per parameter), by default a ``torch.optim.Adam`` at
    ``learning_rate`` and optax's defaults (betas 0.9 and 0.999, eps 1e-8).
    ``step_fn(state, scene, camera, target, tau=None) -> (state, loss)``
    renders ``merge(scene, params)`` (by default ``merge_params``) at
    ``width`` x ``height`` and ``depth`` (with ``soft``, ``render_soft`` at
    ``soft_tau_z`` and at ``tau``, or ``soft_tau`` when ``tau`` is None: a
    fit may anneal it step by step, since the soft tables and gates are
    built from it on every render; the soft path's ``depth`` counts its
    expected-surface reflections), takes the MSE against ``target``
    (``[H, W, 3]``), and does one backward and one optimizer update, in
    place. ``device=None`` runs on CUDA.
    """
    if mesh is not None:
        raise NotImplementedError(
            "the pixel-sharded fit over a mesh is not ported yet (ROADMAP "
            "queue 1, item 9)"
        )

    def init_fn(scene: Scene) -> FitState:
        params = {
            k: v.detach().clone().requires_grad_(True)
            for k, v in params_fn(scene).items()
        }
        if optimizer is not None:
            opt = optimizer(params)
        else:
            opt = torch.optim.Adam(
                list(params.values()), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8
            )
        return FitState(params=params, optimizer=opt, step=0)

    def step_fn(state: FitState, scene: Scene, camera: Camera, target: torch.Tensor,
                tau=None) -> tuple[FitState, torch.Tensor]:
        if tau is not None and not soft:
            raise ValueError("tau is the soft renderer's temperature; this step renders hard")
        state.optimizer.zero_grad(set_to_none=True)
        full = merge(scene, state.params)
        if soft:
            img = render_soft(full, camera, width, height,
                              tau=soft_tau if tau is None else tau, tau_z=soft_tau_z,
                              tonemap=tonemap, depth=depth, device=device)
        else:
            img = render(full, camera, width, height, depth=depth, tonemap=tonemap,
                         device=device)
        loss = torch.mean((img - target) ** 2)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, loss.detach()

    return init_fn, step_fn
