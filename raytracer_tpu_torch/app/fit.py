"""The differentiable-fit app (BASELINE config 4): recover a scene from an image.

Render the true scene with the hard renderer as the target, move the sphere
centres and colours by a seeded draw, then recover them by Adam through the
soft renderer (the hard one has no gradient at silhouettes): a cosine
learning-rate decay, and a soft temperature annealed from 4x down to the
target by 60% of the run. Writes ``target.png``, ``initial.png``,
``final.png`` and ``final_hard.png``, ``metrics.jsonl`` and a resumable
``checkpoint.npz``, and scores the result by the hard render's PSNR. With a
mesh (``cfg.mesh``, ``--mesh``) every rank runs the loop on its rows and
only rank 0 writes files and prints.
"""

from __future__ import annotations

import contextlib
import json
import math
import time
from pathlib import Path

import numpy as np
import torch

from raytracer_tpu_torch.app.config import RenderConfig
from raytracer_tpu_torch.core.types import resolve_device
from raytracer_tpu_torch.diff.soft import render_soft
from raytracer_tpu_torch.io import save_png
from raytracer_tpu_torch.parallel.hosts import is_lead
from raytracer_tpu_torch.parallel.train import make_fit_step, merge_params
from raytracer_tpu_torch.render.integrator import render
from raytracer_tpu_torch.utils.checkpoint import load_fit_state, save_fit_state

__all__ = ["run_fit", "cosine_decay", "anneal_tau", "perturbed_params"]


def cosine_decay(steps: int, alpha: float = 0.05):
    """The learning-rate factor at update ``k`` of optax's
    ``cosine_decay_schedule(lr, decay_steps=steps, alpha=alpha)``, as a
    ``LambdaLR`` takes it."""

    def factor(k: int) -> float:
        cosine = 0.5 * (1.0 + math.cos(math.pi * min(k, steps) / steps))
        return (1.0 - alpha) * cosine + alpha

    return factor


def anneal_tau(step: int, steps: int, soft_tau: float) -> float:
    """The soft temperature of the update after ``step`` updates: 4x
    ``soft_tau`` at the start, decaying exponentially to ``soft_tau`` at 60%
    of ``steps`` and held there, in float32 as the JAX package computes it."""
    f32 = np.float32
    frac = np.minimum(f32(step) / f32(0.6 * max(steps, 1)), f32(1.0))
    return float(f32(soft_tau) * np.exp(np.log(f32(4.0)) * (f32(1.0) - frac)))


def perturbed_params(truth, perturb: float) -> dict:
    """The fit's start: the true centres and colours plus uniform draws in
    [-perturb, perturb) from ``np.random.default_rng(0)`` (centres first),
    each rounded to float32 before the add; colours clipped to [0, 1]."""
    rng = np.random.default_rng(0)
    n = len(truth.spheres)
    dev = truth.spheres.center.device
    d_center, d_color = (
        torch.from_numpy(rng.uniform(-perturb, perturb, (n, 3)).astype(np.float32)).to(dev)
        for _ in range(2)
    )
    return {
        "center": truth.spheres.center + d_center,
        "color": torch.clamp(truth.spheres.material.color + d_color, 0.0, 1.0),
    }


def run_fit(
    cfg: RenderConfig,
    *,
    steps: int = 200,
    lr: float = 2e-2,
    perturb: float = 0.15,
    soft_tau: float = 0.01,
    out_dir: Path = Path("fit_out"),
    resume: str | None = None,
    checkpoint_every: int = 50,
    log_every: int = 10,
    device=None,
) -> int:
    """Fit ``cfg``'s scene to its hard render for ``steps`` Adam updates
    (``resume``: a checkpoint to continue from, then ``steps`` more) on
    ``device`` (``None``: CUDA). Logs a ``metrics.jsonl`` line (step, the
    update's loss, the mean centre error after it, seconds) at the first
    update and every ``log_every``, checkpoints every ``checkpoint_every``
    and at the end, and ends with a line of the final centre error, loss
    and hard-render PSNR. With a mesh (``cfg.build_mesh``) every rank of it
    calls this and steps on its rows of the frame (on ``mesh.device``);
    rank 0 alone writes and prints."""
    mesh = cfg.build_mesh(device=device)
    dev = resolve_device(device)
    lead = is_lead()
    out_dir = Path(out_dir)
    if lead:
        out_dir.mkdir(parents=True, exist_ok=True)
    w, h, depth = cfg.width, cfg.height, cfg.depth

    def write_png(name: str, img: torch.Tensor) -> None:
        if lead:
            save_png(out_dir / name, img)

    def checkpoint() -> None:
        if lead:
            save_fit_state(out_dir / "checkpoint.npz", state, scheduler)

    truth = cfg.build_scene(device=dev)
    camera = cfg.build_camera(device=dev)
    # The target comes from the hard renderer: the soft model being fitted
    # did not make it (the soft render converges to the hard one as tau -> 0).
    with torch.no_grad():
        target = render(truth, camera, w, h, depth=depth, tonemap=cfg.tonemap, device=dev)
    write_png("target.png", target)

    init_fn, step_fn = make_fit_step(
        w, h, mesh=mesh, depth=depth, learning_rate=lr, tonemap=cfg.tonemap,
        device=dev, soft=True, soft_tau=soft_tau,
    )
    state = init_fn(merge_params(truth, perturbed_params(truth, perturb)))
    # Cosine-decayed Adam: a constant rate oscillates around the optimum
    # late in the fit; decaying to lr/20 converges past the plateau.
    scheduler = torch.optim.lr_scheduler.LambdaLR(state.optimizer, cosine_decay(max(steps, 1)))
    if resume:
        load_fit_state(resume, state, scheduler)

    def soft_frame():
        with torch.no_grad():
            return render_soft(merge_params(truth, state.params), camera, w, h, tau=soft_tau,
                               tonemap=cfg.tonemap, depth=depth, device=dev)

    def center_err() -> float:
        return float((state.params["center"].detach() - truth.spheres.center).abs().mean())

    write_png("initial.png", soft_frame())
    loss = torch.tensor(float("nan"))
    with open(out_dir / "metrics.jsonl", "a") if lead else contextlib.nullcontext() as metrics:

        def log(line: str) -> None:
            if lead:
                print(line, flush=True)
                metrics.write(line + "\n")
                metrics.flush()

        t0 = time.perf_counter()
        for i in range(steps):
            tau_k = anneal_tau(state.step, steps, soft_tau)
            state, loss = step_fn(state, truth, camera, target, tau=tau_k)
            scheduler.step()  # optax reads its schedule at the count before the update
            if (i + 1) % log_every == 0 or i == 0:
                log(json.dumps({
                    "step": state.step,
                    "loss": float(loss),
                    "center_err": center_err(),
                    "elapsed_s": round(time.perf_counter() - t0, 2),
                }))
            if (i + 1) % checkpoint_every == 0:
                checkpoint()

        checkpoint()
        write_png("final.png", soft_frame())
        # The recovered scene on the hard renderer: did the geometry
        # reproduce the target, not just the soft surrogate.
        with torch.no_grad():
            hard_final = render(merge_params(truth, state.params), camera, w, h, depth=depth,
                                tonemap=cfg.tonemap, device=dev)
        write_png("final_hard.png", hard_final)
        mse_hard = float(torch.mean((hard_final - target) ** 2))
        psnr = 10.0 * math.log10(1.0 / max(mse_hard, 1e-12))
        log(json.dumps({"final_center_err": center_err(), "final_loss": float(loss),
                        "psnr_hard_db": round(psnr, 2)}))
    return 0
