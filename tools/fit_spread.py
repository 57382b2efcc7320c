"""How far runs of the c4 fit app spread on one CUDA card, and why.

    python3 tools/fit_spread.py [--runs N] [--out FILE]

Runs ``app.fit.run_fit`` on the c4 config (600 steps, tau 2e-3, as
``chip_smoke.py``'s app phase runs it through the command line) N times from
the same seed in one process, and prints each run's final loss, centre
error and hard PSNR beside the bars ``chip_smoke.py`` holds them to, with
the spheres whose centres ended furthest from the truth. Then it asks where
runs part: whether one soft step's gradients, taken twice from the same
state, are equal bit for bit, and whether two hard renders of c5 (the
per-level chain at 3840x2160) have their non-finite pixels in the same
places and the same ``to_u8`` bytes.

Prints the card's name and power limit, a line per measurement, and one
JSON line of them all (also written to FILE with ``--out``).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from raytracer_tpu_torch import merge_params, render  # noqa: E402
from raytracer_tpu_torch.app.config import get_config  # noqa: E402
from raytracer_tpu_torch.app.fit import perturbed_params, run_fit  # noqa: E402
from raytracer_tpu_torch.diff.soft import render_soft  # noqa: E402
from raytracer_tpu_torch.io import to_u8  # noqa: E402
from raytracer_tpu_torch.ops import _build  # noqa: E402
from raytracer_tpu_torch.utils.checkpoint import read_fit_state  # noqa: E402


def fit_runs(n_runs: int, tmp: Path) -> list:
    cfg = get_config("c4-fit-64sphere")
    truth_center = cfg.build_scene(device="cuda").spheres.center.cpu().numpy()
    rows = []
    for k in range(n_runs):
        out = tmp / f"run{k}"
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            run_fit(cfg, steps=cs.C4_FIT_STEPS, soft_tau=2e-3, out_dir=out, device="cuda")
        seconds = time.perf_counter() - t0
        final = json.loads((out / "metrics.jsonl").read_text().splitlines()[-1])
        err = np.abs(read_fit_state(out / "checkpoint.npz").params["center"] - truth_center)
        per_sphere = err.mean(axis=1)
        worst = np.argsort(per_sphere)[::-1][:4]
        row = dict(run=k, seconds=round(seconds, 2), **final,
                   passes=(final["final_loss"] <= cs.C4_FIT_BARS["final_loss"]
                           and final["final_center_err"] <= cs.C4_FIT_BARS["final_center_err"]
                           and final["psnr_hard_db"] >= cs.C4_FIT_BARS["psnr_hard_db"]),
                   worst_spheres={int(s): round(float(per_sphere[s]), 4) for s in worst})
        rows.append(row)
        print(f"fit run {k}: {row}", flush=True)
    return rows


def gradient_repeat(tau: float) -> dict:
    """One soft step's loss gradient at the fit's start, taken twice."""
    cfg = get_config("c4-fit-64sphere")
    truth, camera = cfg.build_scene(device="cuda"), cfg.build_camera(device="cuda")
    with torch.no_grad():
        target = render(truth, camera, cfg.width, cfg.height, depth=cfg.depth, device="cuda")
    start = perturbed_params(truth, 0.15)
    grads = []
    for _ in range(2):
        params = {k: v.clone().requires_grad_(True) for k, v in start.items()}
        img = render_soft(merge_params(truth, params), camera, cfg.width, cfg.height, tau=tau,
                          depth=cfg.depth, device="cuda")
        loss = torch.mean((img - target) ** 2)
        loss.backward()
        grads.append({k: v.grad.detach().clone() for k, v in params.items()})
    out = {}
    for k in grads[0]:
        a, b = grads[0][k], grads[1][k]
        out[k] = dict(differ=int((a != b).sum()), of=a.numel(),
                      max_rel=float(((a - b).abs() / a.abs().clamp_min(1e-30)).max()))
    return out


def c5_repeat() -> dict:
    cfg = get_config("c5-4k-1024sphere")
    imgs = []
    for _ in range(2):
        with torch.no_grad():
            imgs.append(render(cfg.build_scene(device="cuda"), cfg.build_camera(device="cuda"),
                               cfg.width, cfg.height, depth=cfg.depth, tonemap=cfg.tonemap,
                               fold=cfg.fold, device="cuda"))
    a, b = (x.cpu() for x in imgs)
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    both = fa & fb
    return dict(nonfinite=(int((~fa).sum()), int((~fb).sum())),
                nonfinite_same_places=bool(torch.equal(fa, fb)),
                finite_equal=bool(torch.equal(a[both], b[both])),
                u8_equal=bool(np.array_equal(to_u8(a), to_u8(b))),
                nan=(int(a.isnan().sum()), int(b.isnan().sum())))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=8)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fit_spread: needs a CUDA card", file=sys.stderr)
        return 1
    print(cs.card_line(), flush=True)
    _build.build(["trace_whole", "ray_stats", "trace_level", "soft_level", "soft_level_bwd"])
    result = {}
    for tau in (8e-3, 2e-3):
        g = gradient_repeat(tau)
        result[f"gradient_repeat_tau{tau:g}"] = g
        print(f"soft step gradient taken twice, tau {tau:g}: {g}", flush=True)
    result["c5_repeat"] = c5_repeat()
    print(f"c5 rendered twice: {result['c5_repeat']}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        rows = fit_runs(args.runs, Path(tmp))
    errs = [r["final_center_err"] for r in rows]
    result.update(runs=rows, bars=cs.C4_FIT_BARS, passed=sum(r["passes"] for r in rows),
                  center_err_min=min(errs), center_err_max=max(errs),
                  center_err_median=statistics.median(errs))
    print(f"fit runs passing the bars: {result['passed']} of {len(rows)}; centre error "
          f"{min(errs):.5f}-{max(errs):.5f} (median {statistics.median(errs):.5f})", flush=True)
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
