"""The differentiable-rendering fit step.

Fit scene leaves (by default the sphere centers and colours) to a target
image by Adam on the image MSE: one render with gradients, one backward and
one update per step. The hard renderer (``render``: its forward kernels with
residuals, then their backward kernels) has no gradient at silhouettes;
geometry fits take the soft one (``soft=True``: ``render_soft``, the soft
level kernels and their backward).

With a mesh (``parallel/mesh.py``) each rank renders only its rows
(``parallel/render.py``: ``hard_tile``, ``soft_tile``) and takes their term
of the loss; after the backward the gradients are summed over the mesh, so
every rank takes the same update and the parameters stay the same on every
rank, bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from raytracer_tpu_torch.core.types import Camera, Scene
from raytracer_tpu_torch.diff.soft import render_soft
from raytracer_tpu_torch.parallel import comm
from raytracer_tpu_torch.parallel.mesh import PRIM_AXIS, Mesh
from raytracer_tpu_torch.parallel.render import hard_tile, soft_tile
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
    mesh: Mesh | None = None,
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

    With a ``mesh`` every rank of it calls ``step_fn`` with the same
    arguments, and the step runs on ``mesh.device``: each rank renders its
    rows (the soft path's rows over every rank, the hard path's over
    ``px``) and takes the mean squared error of its rows that lie in the
    frame against the same rows of ``target``, times their share of the
    frame's rows (and over ``prim``, whose ranks hold the same rows); after
    the backward the
    gradients are summed over the mesh, then each rank takes the same
    update. The returned loss is the mesh's sum of those terms, the MSE of
    the whole frame.
    """
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh (make_mesh), not "
                        f"{type(mesh).__name__}")

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

    def _mesh_loss(state: FitState, full: Scene, camera: Camera, target: torch.Tensor,
                   tau) -> torch.Tensor:
        """This rank's term, its backward, the gradients summed over the
        mesh; the mesh's sum of the terms."""
        if soft:
            tile, row0 = soft_tile(full, camera, width, height, mesh=mesh,
                                   tau=soft_tau if tau is None else tau, tau_z=soft_tau_z,
                                   tonemap=tonemap, depth=depth)
            share = 1
        else:
            tile, row0 = hard_tile(full, camera, width, height, mesh=mesh, depth=depth,
                                   tonemap=tonemap)
            share = mesh.shape[PRIM_AXIS]
        rows = max(0, min(tile.shape[0], height - row0))  # pad rows past the frame drop out
        if rows:
            want = target.to(mesh.device)[row0:row0 + rows]
            # The mean of this rank's rows, weighted by their share of the
            # frame: a weight of exactly 1 on a 1x1 mesh, so that its step
            # is the single-rank step bit for bit.
            term = torch.mean((tile[:rows] - want) ** 2) * (rows / (height * share))
        else:
            term = tile[:0].sum()  # no rows in the frame: a zero term, the same backward
        term.backward()
        comm.sum_grads(state.params.values(), mesh.group)
        return comm.all_sum(term, mesh.group)

    def step_fn(state: FitState, scene: Scene, camera: Camera, target: torch.Tensor,
                tau=None) -> tuple[FitState, torch.Tensor]:
        if tau is not None and not soft:
            raise ValueError("tau is the soft renderer's temperature; this step renders hard")
        state.optimizer.zero_grad(set_to_none=True)
        full = merge(scene, state.params)
        if mesh is not None:
            loss = _mesh_loss(state, full, camera, target, tau)
        else:
            if soft:
                img = render_soft(full, camera, width, height,
                                  tau=soft_tau if tau is None else tau, tau_z=soft_tau_z,
                                  tonemap=tonemap, depth=depth, device=device)
            else:
                img = render(full, camera, width, height, depth=depth, tonemap=tonemap,
                             device=device)
            loss = torch.mean((img - target) ** 2)
            loss.backward()
            loss = loss.detach()
        state.optimizer.step()
        state.step += 1
        return state, loss

    return init_fn, step_fn
