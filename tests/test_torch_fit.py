"""The port's fit app on the CPU against the JAX package's pieces: the
cosine schedule, the tau anneal, the seeded draws, Adam under the schedule,
the fit-state checkpoints (and the JAX package's, carried across), the
annealed step, and the command line's fit with its resume."""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from raytracer_tpu.models import scenes as jscenes
from raytracer_tpu.utils.checkpoint import save_pytree
from raytracer_tpu_torch.app.cli import main
from raytracer_tpu_torch.app.fit import anneal_tau, cosine_decay, perturbed_params
from raytracer_tpu_torch.diff.soft import render_soft
from raytracer_tpu_torch.io import load_image
from raytracer_tpu_torch.models import scenes as tscenes
from raytracer_tpu_torch.parallel.train import make_fit_step, merge_params
from raytracer_tpu_torch.render.integrator import render
from raytracer_tpu_torch.utils.checkpoint import (
    from_jax_fit_checkpoint,
    load_fit_state,
    read_fit_state,
    restore_fit_state,
    save_fit_state,
)

torch.set_num_threads(1)

W, H = 16, 12  # the fit steps' frame: grid-4 fills a few pixels of it


def _scheduled(state, steps):
    return torch.optim.lr_scheduler.LambdaLR(state.optimizer, cosine_decay(steps))


@pytest.fixture(scope="module")
def grid4():
    truth = tscenes.grid_sphere_scene(4, device="cpu")
    cam = tscenes.reference_demo_camera("cpu")
    with torch.no_grad():
        target = render(truth, cam, W, H, depth=1, device="cpu")
    return truth, cam, target, merge_params(truth, perturbed_params(truth, 0.08))


def test_lambda_lr_is_optax_cosine_schedule():
    """Adam's rate under ``LambdaLR(cosine_decay(20))``, stepped after each
    update, equals ``optax.cosine_decay_schedule(lr, 20, alpha=0.05)`` at
    the update's count, past the decay's end too (rtol 1e-6: optax
    computes in float32, the factor in float64)."""
    p = torch.zeros(3, requires_grad=True)
    opt = torch.optim.Adam([p], lr=2e-2)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, cosine_decay(20))
    want = optax.cosine_decay_schedule(2e-2, decay_steps=20, alpha=0.05)
    for k in range(24):
        np.testing.assert_allclose(opt.param_groups[0]["lr"], float(want(k)), rtol=1e-6)
        p.grad = torch.ones(3)
        opt.step()
        sched.step()


def test_tau_anneal_is_the_jax_formula():
    """``anneal_tau`` equals the JAX fit's float32 anneal at every step of
    a 6- and a 600-step run and past their ends (rtol 1e-6: numpy's and
    XLA's float32 exp and log may differ in the last bit)."""
    for steps, soft_tau in ((6, 2e-3), (600, 2e-3), (600, 0.01)):
        k = jnp.arange(steps + 5, dtype=jnp.int32)
        frac = jnp.minimum(k.astype(jnp.float32) / (0.6 * max(steps, 1)), 1.0)
        want = np.asarray(soft_tau * jnp.exp(jnp.log(4.0) * (1.0 - frac)))
        got = [anneal_tau(int(i), steps, soft_tau) for i in k]
        np.testing.assert_allclose(got, want, rtol=1e-6)
        assert got[0] == pytest.approx(4 * soft_tau, rel=1e-6)
        assert got[int(0.6 * steps) + 1] == pytest.approx(soft_tau, rel=1e-6)


def test_draws_equal_the_jax_fits_bit_for_bit():
    """The perturbed centres and clipped colours equal those of the JAX
    fit's seed-0 draws (each rounded to float32 before the add)."""
    for n, perturb in ((4, 0.08), (64, 0.15)):
        jt = jscenes.grid_sphere_scene(n)
        rng = np.random.default_rng(0)
        want_c = jt.spheres.center + jnp.asarray(rng.uniform(-perturb, perturb, (n, 3)),
                                                 jnp.float32)
        want_k = jnp.clip(jt.spheres.material.color
                          + jnp.asarray(rng.uniform(-perturb, perturb, (n, 3)), jnp.float32),
                          0.0, 1.0)
        got = perturbed_params(tscenes.grid_sphere_scene(n, device="cpu"), perturb)
        assert np.array_equal(got["center"].numpy(), np.asarray(want_c))
        assert np.array_equal(got["color"].numpy(), np.asarray(want_k))


def test_adam_under_the_schedule_is_optax_adam():
    """20 updates of torch's Adam under the schedule and of
    ``optax.adam(schedule)`` on one seeded gradient sequence give the same
    parameters and moments (rtol 1e-5: the two round their bias corrections
    in another order)."""
    rng = np.random.default_rng(7)
    p0 = {k: rng.normal(size=(5, 3)).astype(np.float32) for k in ("center", "color")}
    grads = [{k: rng.normal(size=(5, 3)).astype(np.float32) for k in p0} for _ in range(20)]
    tx = optax.adam(optax.cosine_decay_schedule(2e-2, decay_steps=20, alpha=0.05))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jst = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in p0.items()}
    opt = torch.optim.Adam(list(tp.values()), lr=2e-2, betas=(0.9, 0.999), eps=1e-8)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, cosine_decay(20))
    for g in grads:
        upd, jst = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jst, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        sched.step()
        for k, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-5)
            np.testing.assert_allclose(opt.state[p]["exp_avg"].numpy(), np.asarray(jst[0].mu[k]),
                                       rtol=1e-5, atol=1e-8)
            np.testing.assert_allclose(opt.state[p]["exp_avg_sq"].numpy(),
                                       np.asarray(jst[0].nu[k]), rtol=1e-5, atol=1e-10)


def test_checkpoint_round_trip_and_structure_check(tmp_path, grid4):
    """A saved state (params, Adam's moments and step, the scheduler's
    epoch and rate, the fit's step) loads back exactly into a fresh one; a
    state of other shapes, or a file whose structure string does not
    describe its arrays, is refused."""
    truth, cam, target, start = grid4
    init_fn, step_fn = make_fit_step(W, H, soft=True, device="cpu")
    state = init_fn(start)
    sched = _scheduled(state, 10)
    for _ in range(2):
        state, _ = step_fn(state, truth, cam, target)
        sched.step()
    path = save_fit_state(tmp_path / "ck.npz", state, sched)
    fresh = init_fn(truth)
    fresh_sched = _scheduled(fresh, 10)
    load_fit_state(path, fresh, fresh_sched)
    assert fresh.step == 2 and fresh_sched.last_epoch == 2
    assert fresh.optimizer.param_groups[0]["lr"] == state.optimizer.param_groups[0]["lr"]
    for k, p in state.params.items():
        q = fresh.params[k]
        assert torch.equal(p, q)
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(state.optimizer.state[p][key], fresh.optimizer.state[q][key])

    other = init_fn(tscenes.grid_sphere_scene(5, device="cpu"))
    with pytest.raises(ValueError, match="structure mismatch"):
        load_fit_state(path, other, _scheduled(other, 10))
    data = dict(np.load(path))
    data["__structure__"] = np.frombuffer(b"something else", np.uint8)
    np.savez(tmp_path / "bad.npz", **data)
    with pytest.raises(ValueError, match="does not describe"):
        read_fit_state(tmp_path / "bad.npz")


def test_resumed_steps_equal_uninterrupted_ones(tmp_path, grid4):
    """4 annealed, scheduled steps equal 2 steps, a save, a load into a
    fresh state and 2 more, exactly on the CPU."""
    truth, cam, target, start = grid4
    init_fn, step_fn = make_fit_step(W, H, soft=True, soft_tau=2e-3, device="cpu")

    def run(state, sched, n):
        losses = []
        for _ in range(n):
            state, loss = step_fn(state, truth, cam, target, tau=anneal_tau(state.step, 4, 2e-3))
            sched.step()
            losses.append(float(loss))
        return losses

    a = init_fn(start)
    losses_a = run(a, _scheduled(a, 4), 4)
    b = init_fn(start)
    sched_b = _scheduled(b, 4)
    losses_b = run(b, sched_b, 2)
    save_fit_state(tmp_path / "half.npz", b, sched_b)
    c = init_fn(truth)
    sched_c = _scheduled(c, 4)
    load_fit_state(tmp_path / "half.npz", c, sched_c)
    losses_b += run(c, sched_c, 2)
    assert losses_a == losses_b
    assert c.step == 4
    for k in a.params:
        assert torch.equal(a.params[k], c.params[k])


def test_jax_fit_checkpoints_carried_across(tmp_path):
    """``from_jax_fit_checkpoint`` reads the JAX package's 600-step c4
    checkpoint and a ``save_pytree`` file of an ``optax.adam(schedule)``
    state after 2 updates, leaf for leaf; restored into a port state, one
    more update of each gives the same parameters (rtol 1e-5, as Adam's
    rounding allows)."""
    rec = from_jax_fit_checkpoint("docs/fit_c4/checkpoint.npz")
    assert rec.step == 600 and rec.scheduler_epoch == 600
    data = np.load("docs/fit_c4/checkpoint.npz")
    assert np.array_equal(rec.params["center"], data["leaf_6"])
    assert np.array_equal(rec.params["color"], data["leaf_7"])
    assert np.array_equal(rec.adam["color"]["exp_avg_sq"], data["leaf_4"])
    assert rec.adam["center"]["step"] == 600.0

    rng = np.random.default_rng(3)
    params = {k: jnp.asarray(rng.normal(size=(4, 3)).astype(np.float32))
              for k in ("center", "color")}
    tx = optax.adam(optax.cosine_decay_schedule(2e-2, decay_steps=5, alpha=0.05))
    opt_state = tx.init(params)
    grads = [{k: jnp.asarray(rng.normal(size=(4, 3)).astype(np.float32)) for k in params}
             for _ in range(3)]
    for g in grads[:2]:
        upd, opt_state = tx.update(g, opt_state, params)
        params = optax.apply_updates(params, upd)
    save_pytree(tmp_path / "jax.npz", {"params": params, "opt": opt_state,
                                       "step": jnp.int32(2)})
    rec = from_jax_fit_checkpoint(tmp_path / "jax.npz")
    assert rec.step == 2 and rec.scheduler_epoch == 2
    for k in params:
        assert np.array_equal(rec.params[k], np.asarray(params[k]))
        assert np.array_equal(rec.adam[k]["exp_avg"], np.asarray(opt_state[0].mu[k]))
        assert np.array_equal(rec.adam[k]["exp_avg_sq"], np.asarray(opt_state[0].nu[k]))
        assert rec.adam[k]["step"] == 2.0

    scene = tscenes.grid_sphere_scene(4, device="cpu")
    init_fn, _ = make_fit_step(W, H, soft=True, device="cpu")
    state = init_fn(scene)
    sched = _scheduled(state, 5)
    restore_fit_state(state, sched, rec)
    np.testing.assert_allclose(state.optimizer.param_groups[0]["lr"],
                               float(optax.cosine_decay_schedule(2e-2, 5, alpha=0.05)(2)),
                               rtol=1e-6)
    upd, opt_state = tx.update(grads[2], opt_state, params)
    params = optax.apply_updates(params, upd)
    for k, p in state.params.items():
        p.grad = torch.from_numpy(np.array(grads[2][k]))
    state.optimizer.step()
    for k, p in state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]), rtol=1e-5)


def test_step_tau_equals_a_step_built_with_that_tau(grid4):
    """``step_fn(tau=t)`` equals, bit for bit, the step of a fit built with
    ``soft_tau=t``; the hard step refuses a tau."""
    truth, cam, target, start = grid4
    t = anneal_tau(0, 10, 2e-3)
    init_a, step_a = make_fit_step(W, H, soft=True, soft_tau=0.01, device="cpu")
    init_b, step_b = make_fit_step(W, H, soft=True, soft_tau=t, device="cpu")
    a, b = init_a(start), init_b(start)
    a, loss_a = step_a(a, truth, cam, target, tau=t)
    b, loss_b = step_b(b, truth, cam, target)
    assert torch.equal(loss_a, loss_b)
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k])
    _, step_hard = make_fit_step(W, H, device="cpu")
    with pytest.raises(ValueError, match="hard"):
        step_hard(a, truth, cam, target, tau=t)


def test_cli_fit_writes_every_artefact_and_resumes(tmp_path, capsys):
    """``fit`` on grid-4 at 48x36, 6 steps, ``--device cpu``: the four PNGs,
    ``metrics.jsonl`` (step 1's line, then the final line) and the
    checkpoint; step 1's loss is the MSE of the soft render of the start at
    4x tau against the hard target (rtol 1e-6). A resume of 2 steps appends
    step 7's line and a final line, and checkpoints step 8."""
    out = tmp_path / "fit"
    args = ["fit", "--scene", "grid", "--n", "4", "--width", "48", "--height", "36",
            "--perturb", "0.08", "--device", "cpu", "-o", str(out)]
    assert main([*args, "--steps", "6"]) == 0
    for name in ("target", "initial", "final", "final_hard"):
        assert load_image(out / f"{name}.png").shape == (36, 48, 3)
    lines = [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]
    assert [set(x) for x in lines] == [{"step", "loss", "center_err", "elapsed_s"},
                                       {"final_center_err", "final_loss", "psnr_hard_db"}]
    assert lines[0]["step"] == 1 and np.isfinite(lines[1]["psnr_hard_db"])
    assert capsys.readouterr().out.strip().splitlines()[-1] == json.dumps(lines[1])

    truth = tscenes.grid_sphere_scene(4, device="cpu")
    cam = tscenes.reference_demo_camera("cpu")
    with torch.no_grad():
        target = render(truth, cam, 48, 36, depth=1, device="cpu")
        start = render_soft(merge_params(truth, perturbed_params(truth, 0.08)), cam, 48, 36,
                            tau=anneal_tau(0, 6, 2e-3), depth=1, device="cpu")
    np.testing.assert_allclose(lines[0]["loss"], float(torch.mean((start - target) ** 2)),
                               rtol=1e-6)
    assert read_fit_state(out / "checkpoint.npz").step == 6

    assert main([*args, "--steps", "2", "--resume", str(out / "checkpoint.npz")]) == 0
    lines = [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]
    assert len(lines) == 4 and lines[2]["step"] == 7 and "final_loss" in lines[3]
    rec = read_fit_state(out / "checkpoint.npz")
    assert rec.step == 8 and rec.scheduler_epoch == 8
