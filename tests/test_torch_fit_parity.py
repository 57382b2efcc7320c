"""The fit app as a whole against the JAX package's, two steps on the CPU.

The port's ``run_fit`` (grid-4, 32x24, depth 1, soft tau 2e-3) against the
same two steps built from the JAX package's pieces, op by op under
``jax.disable_jit()``: its hard ``render`` target, the seed-0 draws,
``jax.value_and_grad`` of the image MSE through its ``render_soft`` at the
annealed tau, and ``optax.adam`` under the cosine schedule. The port is
held to the op-by-op JAX call, as every soft parity test is (the JAX
package's jitted soft trace differs from its own op-by-op one by up to
8.5e-3 on the CPU).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from raytracer_tpu.diff.soft import render_soft as j_render_soft
from raytracer_tpu.models import scenes as jscenes
from raytracer_tpu.parallel.train import merge_params as j_merge_params
from raytracer_tpu.render.integrator import render as j_render
from raytracer_tpu_torch.app import fit as tfit
from raytracer_tpu_torch.app.config import RenderConfig
from raytracer_tpu_torch.io import load_image, to_u8
from raytracer_tpu_torch.models import scenes as tscenes
from raytracer_tpu_torch.render.integrator import render
from raytracer_tpu_torch.utils.checkpoint import read_fit_state

torch.set_num_threads(1)

W, H, STEPS, TAU, LR, PERTURB = 32, 24, 2, 2e-3, 2e-2, 0.15


def _jax_fit():
    """The JAX fit's two steps (``app/fit.py``'s arithmetic), op by op:
    the target, and each step's loss and parameters after its update."""
    truth, cam = jscenes.grid_sphere_scene(4), jscenes.reference_demo_camera()
    with jax.disable_jit():
        target = j_render(truth, cam, W, H, depth=1, tonemap=True)
        rng = np.random.default_rng(0)
        params = {
            "center": truth.spheres.center
            + jnp.asarray(rng.uniform(-PERTURB, PERTURB, (4, 3)), jnp.float32),
            "color": jnp.clip(truth.spheres.material.color
                              + jnp.asarray(rng.uniform(-PERTURB, PERTURB, (4, 3)), jnp.float32),
                              0.0, 1.0),
        }
        opt = optax.adam(optax.cosine_decay_schedule(LR, decay_steps=STEPS, alpha=0.05))
        opt_state = opt.init(params)
        losses, after = [], []
        for step in range(STEPS):
            frac = jnp.minimum(jnp.float32(step) / (0.6 * STEPS), 1.0)
            tau_k = TAU * jnp.exp(jnp.log(4.0) * (1.0 - frac))

            def loss_fn(p, tau_k=tau_k):
                img = j_render_soft(j_merge_params(truth, p), cam, W, H, tau=tau_k, depth=1)
                return jnp.mean((img - target) ** 2)

            loss, grads = jax.value_and_grad(loss_fn)(params)
            updates, opt_state = opt.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            losses.append(float(loss))
            after.append({k: np.asarray(v) for k, v in params.items()})
    return np.asarray(target), losses, after


def test_run_fit_two_steps_match_the_jax_fit(tmp_path, monkeypatch, capsys):
    """Targets, each step's loss and the parameters after each step.

    Bars: the targets to 1e-4 on all but 1% of the pixels (the two
    packages' camera-ray rsqrts differ in the last bit, which may flip a
    silhouette pixel); losses to rtol 1e-3 and parameters to atol 1e-4 (XLA
    on the CPU contracts multiply-adds into FMAs and takes an approximate
    rsqrt where the port rounds every operation, ROADMAP queue 3; Adam's
    first steps move each parameter by about the learning rate, 2e-2)."""
    saved = []
    real_save = tfit.save_fit_state

    def save_and_read(path, state, scheduler):
        out = real_save(path, state, scheduler)
        saved.append(read_fit_state(out))
        return out

    monkeypatch.setattr(tfit, "save_fit_state", save_and_read)
    cfg = RenderConfig(name="parity-grid4", scene="grid", scene_args={"n": 4},
                       width=W, height=H, depth=1)
    assert tfit.run_fit(cfg, steps=STEPS, lr=LR, perturb=PERTURB, soft_tau=TAU,
                        out_dir=tmp_path, checkpoint_every=1, log_every=1, device="cpu") == 0
    lines = [json.loads(x) for x in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [x.get("step") for x in lines[:STEPS]] == [1, 2]
    assert [r.step for r in saved] == [1, 2, 2]

    j_target, j_losses, j_after = _jax_fit()
    with torch.no_grad():
        target = render(tscenes.grid_sphere_scene(4, device="cpu"),
                        tscenes.reference_demo_camera("cpu"), W, H, depth=1, device="cpu")
    assert np.array_equal(load_image(tmp_path / "target.png"), to_u8(target))
    far = np.abs(target.numpy() - j_target).max(axis=-1) > 1e-4
    assert far.mean() <= 0.01, far.sum()
    np.testing.assert_allclose([x["loss"] for x in lines[:STEPS]], j_losses, rtol=1e-3)
    for rec, want in zip(saved, j_after):
        for k in ("center", "color"):
            np.testing.assert_allclose(rec.params[k], want[k], atol=1e-4, err_msg=k)
    assert j_losses[1] < j_losses[0]
    final = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert final["final_loss"] == pytest.approx(lines[1]["loss"])
