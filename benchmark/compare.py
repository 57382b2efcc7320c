"""The numbers that decide ``correct``: what the timed path produced against
what the plain reference works out from the same inputs."""

from __future__ import annotations

import math
import statistics

import torch


def pixel_share(img: torch.Tensor, ref: torch.Tensor, tol: float) -> float:
    """The share of pixels whose largest channel difference exceeds ``tol``
    (a pixel that is not finite on either side counts as off)."""
    a, b = img.float(), ref.float()
    off = (torch.abs(a - b) > tol).any(dim=-1) | ~torch.isfinite(a).all(dim=-1) \
        | ~torch.isfinite(b).all(dim=-1)
    return float(off.float().mean())


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def norm_gap(got: dict, want: dict, keep=None) -> float:
    """The worst leaf's gap between the two norms, ``| |got| - |want| |``,
    over the larger of the reference's norm of that leaf and of the median
    leaf. ``keep`` names the leaves compared (default: all)."""
    g, w = _norms(got), _norms(want)
    names = [k for k in w if keep is None or k in keep]
    if not names:
        return 0.0
    median = statistics.median(w[k] for k in names)
    worst = 0.0
    for k in names:
        scale = max(w[k], median)
        gap = abs(g[k] - w[k]) / scale if scale > 0 else abs(g[k])
        worst = max(worst, gap if math.isfinite(gap) else math.inf)
    return worst


def row_share(got: dict, want: dict, tol: float) -> float:
    """The worst leaf's share of rows (a sphere's entries of the leaf) whose
    gap ``|got_j - want_j|`` exceeds ``tol`` times the larger of the
    reference's ``|want_j|`` and the leaf's median ``|want_j|``. A row that
    is not finite is off."""
    worst = 0.0
    for k, w in want.items():
        w = w.double().reshape(w.shape[0], -1)
        g = got[k].double().reshape(w.shape)
        norm = torch.linalg.vector_norm(w, dim=1)
        scale = torch.clamp(norm, min=float(norm.median()))
        gap = torch.linalg.vector_norm(g - w, dim=1)
        off = ~(gap <= tol * scale)
        worst = max(worst, float(off.double().mean()))
    return worst


def moved_leaves(grads: dict) -> set:
    """The leaves whose reference gradient is not nought to rounding: a norm
    of at least a thousandth of the median leaf's."""
    n = _norms(grads)
    median = statistics.median(n.values())
    return {k for k, v in n.items() if v >= 1e-3 * median}


def loss_gap(got: list, want: list) -> float:
    """The largest relative gap between the step losses."""
    worst = 0.0
    for a, b in zip(got, want):
        gap = abs(a - b) / abs(b) if b else abs(a)
        worst = max(worst, gap if math.isfinite(gap) else math.inf)
    return worst if len(got) == len(want) else math.inf


def fit_checks(got: dict, want: dict, grad_tol: float) -> dict:
    """The readings of the first steps: ``first_loss_gap`` (the first
    step's loss), ``loss_gap`` (every step's), ``change_gap`` (the
    parameters' change over the steps, over the leaves the reference
    moves), ``grad_bad_share`` (the first gradient, sphere by sphere, at
    ``grad_tol``) and ``grad_gap`` (the first gradient's worst leaf norm). A
    cell compares those its limits name: ``grad_gap`` rests on a few rays
    whose colour jumps with float32 rounding (``PERF.md``) and is read, not
    compared."""
    return {
        "first_loss_gap": loss_gap(got["losses"][:1], want["losses"][:1]),
        "loss_gap": loss_gap(got["losses"], want["losses"]),
        "change_gap": norm_gap(got["change"], want["change"], moved_leaves(want["grad"])),
        "grad_bad_share": row_share(got["grad"], want["grad"], grad_tol),
        "grad_gap": norm_gap(got["grad"], want["grad"]),
    }


def judged(values: dict, limits: dict) -> dict:
    """``{name: {"value", "limit"}}`` for every number that has a limit."""
    return {k: {"value": v, "limit": limits[k]} for k, v in values.items() if k in limits}


def passes(checks: dict) -> bool:
    return bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
