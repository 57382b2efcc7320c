"""Fit-state checkpoints as ``.npz``: no pickles, the structure checked on load.

A fit state is what resumes a fit exactly: the parameters, Adam's
``exp_avg``, ``exp_avg_sq`` and step count for each of them, the learning
rate scheduler's epoch and the fit's step. ``save_fit_state`` writes it as
plain arrays beside a structure string (the parameter names and shapes);
``load_fit_state`` refuses a file whose structure differs from the state
it loads into. ``from_jax_fit_checkpoint`` reads the JAX package's
``save_pytree`` file of its fit state (optax's Adam under a schedule), in
the same form that ``load_fit_state`` restores.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

__all__ = [
    "FitRecord",
    "save_fit_state",
    "load_fit_state",
    "read_fit_state",
    "restore_fit_state",
    "from_jax_fit_checkpoint",
]

_ADAM_KEYS = ("exp_avg", "exp_avg_sq", "step")

# The treedef string that the JAX package's ``save_pytree`` stores for its
# fit state ``{"params", "opt": optax.adam(schedule).init(params), "step"}``:
# optax's ScaleByAdamState (count, mu, nu), then ScaleByScheduleState
# (count), then the params, then the step; leaves in that order.
JAX_FIT_TREEDEF = (
    "PyTreeDef({'opt': (CustomNode(namedtuple[ScaleByAdamState], [*, {'center': *, "
    "'color': *}, {'center': *, 'color': *}]), CustomNode(namedtuple[ScaleByScheduleState], "
    "[*])), 'params': {'center': *, 'color': *}, 'step': *})"
)


@dataclasses.dataclass
class FitRecord:
    """A fit state as host arrays: ``params[name]``, ``adam[name]`` (a dict
    of ``exp_avg``, ``exp_avg_sq`` and ``step``), the scheduler's epoch and
    the fit's step."""

    params: dict
    adam: dict
    scheduler_epoch: int
    step: int

    def structure(self) -> str:
        return _structure({k: v.shape for k, v in self.params.items()})


def _structure(shapes: dict) -> str:
    fields = ", ".join(f"{k}: f32{list(s)}" for k, s in shapes.items())
    return (f"FitState(params={{{fields}}}, adam={{{', '.join(_ADAM_KEYS)}}} a param, "
            "scheduler_epoch, step)")


def _state_structure(state) -> str:
    return _structure({k: tuple(p.shape) for k, p in state.params.items()})


def _record_of(state, scheduler) -> FitRecord:
    adam = {}
    for name, p in state.params.items():
        s = state.optimizer.state.get(p, {})
        adam[name] = {
            "exp_avg": _np(s["exp_avg"]) if s else np.zeros(p.shape, np.float32),
            "exp_avg_sq": _np(s["exp_avg_sq"]) if s else np.zeros(p.shape, np.float32),
            "step": float(s["step"]) if s else 0.0,
        }
    return FitRecord(params={k: _np(p) for k, p in state.params.items()}, adam=adam,
                     scheduler_epoch=int(scheduler.last_epoch), step=int(state.step))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32, copy=True)


def save_fit_state(path, state, scheduler) -> Path:
    """Write ``state`` (a ``parallel.train.FitState`` whose optimizer is
    Adam) and ``scheduler``'s epoch to ``path`` (``.npz`` is appended when
    missing)."""
    path = Path(path)
    rec = _record_of(state, scheduler)
    arrays = {"__structure__": np.frombuffer(rec.structure().encode(), dtype=np.uint8),
              "scheduler_epoch": np.int64(rec.scheduler_epoch), "step": np.int64(rec.step)}
    for name in rec.params:
        arrays[f"params.{name}"] = rec.params[name]
        for key in _ADAM_KEYS:
            arrays[f"adam.{name}.{key}"] = np.asarray(rec.adam[name][key], np.float32)
    np.savez(path, **arrays)
    return path if path.suffix == ".npz" else path.with_suffix(path.suffix + ".npz")


def read_fit_state(path) -> FitRecord:
    """The fit state that ``save_fit_state`` wrote to ``path``."""
    with np.load(Path(path), allow_pickle=False) as data:
        stored = data["__structure__"].tobytes().decode()
        names = [k[len("params."):] for k in data.files if k.startswith("params.")]
        rec = FitRecord(
            params={k: data[f"params.{k}"] for k in names},
            adam={k: {key: data[f"adam.{k}.{key}"] for key in _ADAM_KEYS} for k in names},
            scheduler_epoch=int(data["scheduler_epoch"]), step=int(data["step"]),
        )
    for k in names:
        rec.adam[k]["step"] = float(rec.adam[k]["step"])
    if stored != rec.structure():
        raise ValueError(f"checkpoint {path}: its structure string {stored!r} does not "
                         f"describe its arrays ({rec.structure()!r})")
    return rec


def restore_fit_state(state, scheduler, rec: FitRecord):
    """Write ``rec`` into ``state`` (parameters in place, Adam's state, the
    step) and ``scheduler`` (its epoch, and the learning rate it gives at
    that epoch); returns ``state``. Raises ``ValueError`` when the
    structures differ."""
    want, got = _state_structure(state), rec.structure()
    if want != got:
        raise ValueError(f"checkpoint structure mismatch:\n saved: {got}\n want:  {want}")
    opt = state.optimizer
    with torch.no_grad():
        for name, p in state.params.items():
            p.copy_(torch.from_numpy(np.asarray(rec.params[name], np.float32)))
            a = rec.adam[name]
            opt.state[p] = {
                # Adam keeps its step count as a float32 tensor on the host.
                "step": torch.tensor(float(a["step"]), dtype=torch.float32),
                "exp_avg": torch.from_numpy(np.array(a["exp_avg"], np.float32)).to(p.device),
                "exp_avg_sq": torch.from_numpy(np.array(a["exp_avg_sq"], np.float32)).to(p.device),
            }
    scheduler.last_epoch = rec.scheduler_epoch
    lrs = [base * fn(rec.scheduler_epoch)
           for base, fn in zip(scheduler.base_lrs, scheduler.lr_lambdas)]
    for group, lr in zip(opt.param_groups, lrs):
        group["lr"] = lr
    scheduler._last_lr = lrs
    state.step = rec.step
    return state


def load_fit_state(path, state, scheduler):
    """Restore the fit state that ``save_fit_state`` wrote to ``path`` into
    ``state`` and ``scheduler`` (a ``LambdaLR`` on its optimizer); returns
    ``state``."""
    return restore_fit_state(state, scheduler, read_fit_state(path))


def from_jax_fit_checkpoint(path) -> FitRecord:
    """The JAX package's fit checkpoint (``save_pytree`` of ``run_fit``'s
    state) as a ``FitRecord``: optax's ``mu`` and ``nu`` are Adam's
    ``exp_avg`` and ``exp_avg_sq``, its counts Adam's step and the
    scheduler's epoch (optax reads its schedule at the count before the
    update, as a ``LambdaLR`` stepped after each update does)."""
    with np.load(Path(path), allow_pickle=False) as data:
        stored = data["__treedef__"].tobytes().decode()
        if stored != JAX_FIT_TREEDEF:
            raise ValueError(f"not a JAX fit checkpoint:\n saved: {stored}\n want:  "
                             f"{JAX_FIT_TREEDEF}")
        leaf = [data[f"leaf_{i}"] for i in range(9)]
    adam_count, mu_c, mu_k, nu_c, nu_k, sched_count, p_c, p_k, step = leaf
    return FitRecord(
        params={"center": p_c.astype(np.float32), "color": p_k.astype(np.float32)},
        adam={"center": {"exp_avg": mu_c, "exp_avg_sq": nu_c, "step": float(adam_count)},
              "color": {"exp_avg": mu_k, "exp_avg_sq": nu_k, "step": float(adam_count)}},
        scheduler_epoch=int(sched_count), step=int(step),
    )
