#!/usr/bin/env python3
"""Build the port's CUDA kernels and drive its main path on one GPU.

    python3 chip_smoke.py

Phases, one line each: the card's name and power limit; the kernel build
from csrc/; every kernel against its plain PyTorch version on the card, at
the shapes the main path and the other fused-class workloads give it; the
main path itself (``render`` of the sprint3 scene at 1920x1080, depth 3),
with the kernel launch counts read around it; the frame time; a ``kernels``
JSON line. The last line is ``{"ok": true, "device": {...}}``. Any failed
check ends the run with a non-zero exit code and no result line. Without
CUDA, or without the package beside it, it exits non-zero at once.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and float32 (non-tensor)
# FLOP/s.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12

# (name, scene factory name and args, width, height, depth). The first is
# the main path's shape; the last has a ragged end (n % 256 != 0).
CASES = (
    ("sprint3_1920x1080_d3", ("sprint3_scene", ()), 1920, 1080, 3),
    ("demo_640x640_d10", ("reference_demo_scene", ()), 640, 640, 10),
    ("grid64_1920x1080_d3", ("grid_sphere_scene", (64,)), 1920, 1080, 3),
    ("mixed_256x128_d2", ("mixed_primitive_scene", ()), 256, 128, 2),
    ("sprint3_333x111_d3", ("sprint3_scene", ()), 333, 111, 3),
)


def trace_whole_ops(counts: dict, idx: np.ndarray, alive: np.ndarray) -> float:
    """Float32 operations the whole-trace kernel needs on this run's data,
    reckoned from csrc/trace_whole.cu (each add, mul, div, sqrt, rsqrt, exp,
    log, min, max and compare counts one), per alive lane and level.

    The sphere fold is counted as one chunk's spheres plus every chunk's
    gate: the least a gated lane can test. So this is a lower bound."""
    n_s, n_w, n_b, n_c = counts["n_s"], counts["n_w"], counts["n_b"], counts["n_c"]
    gate = 26 if counts["gate"] == 0 else 24
    fold = 19 + 39 * n_w + 25 * n_b
    if n_s:
        fold += 25 + gate * n_c + 22 * min(counts["unroll"], n_s)
    per_level = fold + 14  # + sky
    shade = 49 * counts["n_pt"] + 36 * counts["n_sun"] + 35
    record = {"sphere": 38, "wall": 22, "box": 39}
    ops = float(per_level * alive.sum()) + 6.0 * (alive & (idx < 0)).sum()
    for kind, lo, hi in (("sphere", 0, n_s), ("wall", n_s, n_s + n_w),
                         ("box", n_s + n_w, n_s + n_w + n_b)):
        ops += (record[kind] + shade) * (alive & (idx >= lo) & (idx < hi)).sum()
    return ops


def alive_levels(tables, idx: torch.Tensor) -> torch.Tensor:
    """Which lanes carry throughput at each level, from the selections:
    alive at k+1 iff alive at k, hit at k, and the hit's metallic > 0."""
    met = tables.cols["mmt"]
    alive = [torch.ones_like(idx[0], dtype=torch.bool)]
    for k in range(idx.shape[0] - 1):
        hit = idx[k] >= 0
        alive.append(alive[k] & hit & (met[idx[k].clamp_min(0).long()] > 0))
    return torch.stack(alive)


def check_trace_whole(case, device, scale: int = 1) -> dict:
    """The kernel against its plain version on one workload: selections,
    t and rgb, then both timed with CUDA events."""
    from raytracer_tpu_torch.models import scenes
    from raytracer_tpu_torch.ops import cuda_fold
    from raytracer_tpu_torch.ops.trace import MISS_T, raygen_tile
    from raytracer_tpu_torch.utils.profiler import cuda_time_ms

    name, (factory, args), width, height, depth = case
    width, height = max(width // scale, 1), max(height // scale, 1)
    scene = getattr(scenes, factory)(*args, device=device)
    o, d = raygen_tile(scenes.reference_demo_camera(device=device), width, height)
    o, d = o.broadcast_to(d.x.shape), d.broadcast_to(d.x.shape)
    w = torch.ones(d.x.shape, dtype=torch.float32, device=device)
    tables = cuda_fold.fused_tables(scene)
    rgb_k, t_k, i_k = cuda_fold.trace_whole(tables, o, d, w, depth)
    rgb_p, t_p, i_p = cuda_fold.trace_whole_reference(tables, o, d, w, depth)

    alive = alive_levels(tables, i_p)
    mism = alive & (i_k != i_p)
    n_alive = int(alive.sum())
    lines = [
        f"  mismatch level {k} pixel ({y},{x}): kernel {int(i_k[k, y, x])} "
        f"t={float(t_k[k, y, x])!r}, plain {int(i_p[k, y, x])} t={float(t_p[k, y, x])!r}"
        for k, y, x in mism.nonzero().tolist()
    ]
    hit = alive & ~mism & (i_p >= 0)
    t_rel = ((t_k - t_p).abs() / t_p.abs())[hit]
    t_rel_max = float(t_rel.max()) if t_rel.numel() else 0.0
    dead = ~alive
    dead_ok = bool(((i_k[dead] == -1) & (t_k[dead] == MISS_T)).all())
    clean = ~mism.any(dim=0)
    err = torch.stack([(a - b).abs() for a, b in zip(rgb_k, rgb_p)])[:, clean]
    close = torch.stack([
        torch.isclose(a, b, rtol=1e-4, atol=1e-5) for a, b in zip(rgb_k, rgb_p)
    ])[:, clean]
    out = dict(
        name=name, shape=(height, width), depth=depth, alive=n_alive,
        mismatches=int(mism.sum()), mismatch_lines=lines, t_rel_max=t_rel_max,
        dead_ok=dead_ok, max_abs_err=float(err.max()) if err.numel() else 0.0,
        rgb_ok=bool(close.all()),
        finite=all(bool(torch.isfinite(c).all()) for c in rgb_k),
    )
    out["ok"] = (
        out["mismatches"] <= 1e-5 * n_alive and t_rel_max <= 1e-6
        and dead_ok and out["rgb_ok"] and out["finite"]
    )
    n = w.numel()
    out["bytes"] = (7 + 3 + 2 * (depth + 1)) * n * 4
    out["ops"] = trace_whole_ops(tables.counts, i_p.cpu().numpy(), alive.cpu().numpy())
    t_bytes, t_ops = out["bytes"] / PEAK_BYTES_S, out["ops"] / PEAK_F32_S
    out["bound_ms"] = max(t_bytes, t_ops) * 1e3
    out["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    if device != "cpu":
        out["ms"] = statistics.median(cuda_time_ms(
            lambda: cuda_fold.trace_whole(tables, o, d, w, depth), iters=20, warmup=3
        ))
        out["plain_ms"] = statistics.median(cuda_time_ms(
            lambda: cuda_fold.trace_whole_reference(tables, o, d, w, depth),
            iters=3, warmup=1,
        ))
    return out


def drive_main_path(device, width: int = 1920, height: int = 1080, depth: int = 3):
    """``render`` of the sprint3 scene through the public entry point, with
    every kernel's launch count set to 0 just before and read just after."""
    from raytracer_tpu_torch import render
    from raytracer_tpu_torch.models import scenes
    from raytracer_tpu_torch.ops import cuda_fold

    scene = scenes.sprint3_scene(device=device)
    camera = scenes.reference_demo_camera(device=device)
    cuda_fold.trace_whole.launches = 0
    img = render(scene, camera, width, height, depth=depth, device=device)
    if device != "cpu":
        torch.cuda.synchronize()
    launches = {"trace_whole": cuda_fold.trace_whole.launches}
    return img, launches


def count_launches_demo(device) -> dict:
    """Launches of each kernel in one ``render`` of the demo at 640x640,
    depth 10 (the reference renderer's own default frame)."""
    from raytracer_tpu_torch import render
    from raytracer_tpu_torch.models import scenes
    from raytracer_tpu_torch.ops import cuda_fold

    scene = scenes.reference_demo_scene(device=device)
    camera = scenes.reference_demo_camera(device=device)
    cuda_fold.trace_whole.launches = 0
    render(scene, camera, 640, 640, depth=10, device=device)
    return {"trace_whole": cuda_fold.trace_whole.launches}


def frame_breakdown(device, width: int = 1920, height: int = 1080, depth: int = 3,
                    iters: int = 20) -> dict:
    """Median host milliseconds (each ended by a synchronize) of the steps of
    one ``render`` call: packing the scene tables, ray generation, the
    kernel launch, and the tone map with the ``[H, W, 3]`` stack."""
    from raytracer_tpu_torch.models import scenes
    from raytracer_tpu_torch.ops import cuda_fold
    from raytracer_tpu_torch.ops.tonemap import reinhard_tonemap
    from raytracer_tpu_torch.ops.trace import raygen_tile

    scene = scenes.sprint3_scene(device=device)
    camera = scenes.reference_demo_camera(device=device)
    tables = cuda_fold.fused_tables(scene)
    o, d = raygen_tile(camera, width, height)
    o, d = o.broadcast_to(d.x.shape), d.broadcast_to(d.x.shape)
    w = torch.ones(d.x.shape, dtype=torch.float32, device=device)
    rgb, _, _ = cuda_fold.trace_whole(tables, o, d, w, depth)
    steps = {
        "fused_tables": lambda: cuda_fold.fused_tables(scene),
        "raygen": lambda: [c.broadcast_to(d.x.shape) for c in raygen_tile(camera, width, height)],
        "trace_whole": lambda: cuda_fold.trace_whole(tables, o, d, w, depth),
        "tonemap": lambda: reinhard_tonemap(rgb.stacked()),
    }
    out = {}
    for name, fn in steps.items():
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = statistics.median(times)
    return out


def check_image(img, width, height, device) -> dict:
    """Finite, the right shape, in [0, 1), and equal to the CPU plain
    version's render of the same scene on a small frame."""
    from raytracer_tpu_torch import render
    from raytracer_tpu_torch.models import scenes

    out = dict(
        shape_ok=tuple(img.shape) == (height, width, 3),
        finite=bool(torch.isfinite(img).all()),
        range_ok=bool(((img >= 0) & (img < 1)).all()),
    )
    small = [
        render(scenes.sprint3_scene(device=dev), scenes.reference_demo_camera(device=dev),
               96, 64, depth=3, device=dev).cpu()
        for dev in (device, "cpu")
    ]
    out["small_max_abs_err"] = float((small[0] - small[1]).abs().max())
    out["small_close"] = bool(torch.isclose(small[0], small[1], rtol=1e-4, atol=1e-4)
                              .all(dim=-1).float().mean() >= 0.999)
    out["ok"] = all(out[k] for k in ("shape_ok", "finite", "range_ok", "small_close"))
    return out


def check_guards(device) -> dict:
    """On CUDA, work outside the kernel's class raises instead of falling
    back: a 65-sphere scene, depth 11, and a scene leaf that requires grad."""
    from raytracer_tpu_torch import render
    from raytracer_tpu_torch.models import scenes

    camera = scenes.reference_demo_camera(device=device)
    grad_scene = scenes.sprint3_scene(device=device)
    grad_scene = grad_scene.replace(spheres=grad_scene.spheres.replace(
        radius=grad_scene.spheres.radius.clone().requires_grad_(True)))
    cases = {
        "65_spheres": (scenes.grid_sphere_scene(65, device=device), 3),
        "depth_11": (scenes.sprint3_scene(device=device), 11),
        "requires_grad": (grad_scene, 3),
    }
    out = {}
    for name, (scene, depth) in cases.items():
        try:
            render(scene, camera, 32, 16, depth=depth, device=device)
            out[name] = False
        except NotImplementedError:
            out[name] = True
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from raytracer_tpu_torch.ops import _build, cuda_fold
    from raytracer_tpu_torch.utils.profiler import benchmark_render
    from raytracer_tpu_torch.models import scenes

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.build(["trace_whole"])
    print(f"build: trace_whole {time.perf_counter() - t0:.1f} s", flush=True)

    ok = True
    results = []
    for case in CASES:
        r = check_trace_whole(case, "cuda")
        results.append(r)
        ok &= r["ok"]
        print(
            f"trace_whole {r['name']}: ok={r['ok']} alive={r['alive']} "
            f"mismatches={r['mismatches']} t_rel_max={r['t_rel_max']:.3g} "
            f"max_abs_err={r['max_abs_err']:.3g} dead_ok={r['dead_ok']} "
            f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.2f} "
            f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']})", flush=True,
        )
        for line in r["mismatch_lines"]:
            print(line)

    img, launches = drive_main_path("cuda")
    main_ok = launches["trace_whole"] > 0
    demo_launches = count_launches_demo("cuda")
    im = check_image(img, 1920, 1080, "cuda")
    bench = benchmark_render(
        scenes.sprint3_scene(device="cuda"), scenes.reference_demo_camera(device="cuda"),
        1920, 1080, depth=3, iters=20,
    )
    ok &= main_ok and im["ok"]
    main = results[0]
    print(
        f"main path render sprint3 1920x1080 d3: launches={launches} ok={main_ok and im['ok']} "
        f"image={im} frame_ms={bench['frame_ms']:.4f} "
        f"rays_per_s={bench['primary_rays_per_s']:.4g} "
        f"trace_whole_ms={main['ms']:.4f} plain_ms={main['plain_ms']:.2f}", flush=True,
    )

    print(f"demo render 640x640 d10 launches per frame: {demo_launches}", flush=True)
    breakdown = frame_breakdown("cuda")
    print("frame breakdown sprint3 1920x1080 d3 (host ms, synchronized): "
          + " ".join(f"{k}={v:.4f}" for k, v in breakdown.items()), flush=True)

    guards = check_guards("cuda")
    ok &= all(guards.values())
    print(f"guards (raise on CUDA): {guards}", flush=True)

    kernels = [{
        "name": "trace_whole", "route": "cuda",
        "source": "raytracer_tpu_torch/csrc/trace_whole.cu",
        "replaces": "raytracer_tpu/ops/pallas_fold.py:1795",
        "launches": launches["trace_whole"],
        "max_abs_err": max(r["max_abs_err"] for r in results),
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None,
        "check": all(r["ok"] for r in results),
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    if not ok:
        print("chip_smoke: a check failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
