#!/usr/bin/env python3
"""Build the port's CUDA kernels and drive its main paths on one GPU.

    python3 chip_smoke.py

Phases, one line each: the card's name and power limit; the build of both
kernels from csrc/ (one nvcc each, started together); each kernel against
its plain PyTorch version on the card, at the shapes the main paths and the
other fused-class workloads give it (the forward with and without its
residual planes, the backward on the forward's residuals); the render path
(``render`` of the sprint3 scene at 1920x1080, depth 3) and the training
path (10 ``make_fit_step`` steps on the same frame), each with the kernel
launch counts set to 0 just before it and read just after; the frame, fit
step and forward/backward times; the guards; a ``kernels`` JSON line. The
last line is ``{"ok": true, "device": {...}}``. Any failed check ends the
run with a non-zero exit code and no result line. Without CUDA, or without
the package beside it, it exits non-zero at once.
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


def trace_whole_bwd_ops(counts: dict, idx: np.ndarray, alive: np.ndarray) -> float:
    """Float32 operations the backward kernel needs on this run's data,
    reckoned from csrc/trace_whole_bwd.cu as ``trace_whole_ops`` is, per
    alive lane and level: a hit replays its record and runs its adjoint
    (sphere 113, wall 80, box 135), the bounce and accumulate adjoint (88),
    each point light's shading twice and its adjoint (180) and each sun's
    (135), and adds its 14 attribute and 6 per-light cotangents into the
    sums; a miss runs the sky's adjoint (51) and adds its 10 sky
    cotangents."""
    n_s, n_w, n_b = counts["n_s"], counts["n_w"], counts["n_b"]
    n_l = counts["n_pt"] + counts["n_sun"]
    hit_common = 88 + 180 * counts["n_pt"] + 135 * counts["n_sun"] + 14 + 6 * n_l
    ops = 61.0 * (alive & (idx < 0)).sum()
    for rec, lo, hi in ((113, 0, n_s), (80, n_s, n_s + n_w), (135, n_s + n_w, n_s + n_w + n_b)):
        ops += float(rec + hit_common) * (alive & (idx >= lo) & (idx < hi)).sum()
    return float(ops)


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
    # The training forward: the same outputs, and the residual planes (each
    # level k >= 1's input rays and throughput) bit-identical to the plain
    # version's on every lane whose selections agree at every level.
    rgb_r, t_r, i_r, res_k = cuda_fold.trace_whole(tables, o, d, w, depth, emit_res=True)
    res_p = cuda_fold.trace_whole_reference(tables, o, d, w, depth, emit_res=True)[3]
    out["emit_same"] = (all(torch.equal(a, b) for a, b in zip(rgb_r, rgb_k))
                        and torch.equal(t_r, t_k) and torch.equal(i_r, i_k))
    out["res_mismatches"] = int((res_k != res_p)[:, :, clean].any(dim=1).sum())
    out["ok"] = (
        out["mismatches"] <= 1e-5 * n_alive and t_rel_max <= 1e-6
        and dead_ok and out["rgb_ok"] and out["finite"]
        and out["emit_same"] and out["res_mismatches"] == 0
    )
    n = w.numel()
    out["bytes"] = (7 + 3 + 2 * (depth + 1)) * n * 4
    out["ops"] = trace_whole_ops(tables.counts, i_p.cpu().numpy(), alive.cpu().numpy())
    t_bytes, t_ops = out["bytes"] / PEAK_BYTES_S, out["ops"] / PEAK_F32_S
    out["bound_ms"] = max(t_bytes, t_ops) * 1e3
    out["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    t_res = (out["bytes"] + 7 * depth * n * 4) / PEAK_BYTES_S
    out["bound_res_ms"] = max(t_res, t_ops) * 1e3
    if device != "cpu":
        out["ms"] = statistics.median(cuda_time_ms(
            lambda: cuda_fold.trace_whole(tables, o, d, w, depth), iters=20, warmup=3
        ))
        out["ms_res"] = statistics.median(cuda_time_ms(
            lambda: cuda_fold.trace_whole(tables, o, d, w, depth, emit_res=True),
            iters=20, warmup=3,
        ))
        out["plain_ms"] = statistics.median(cuda_time_ms(
            lambda: cuda_fold.trace_whole_reference(tables, o, d, w, depth),
            iters=3, warmup=1,
        ))
    out["forward"] = dict(scene=scene, tables=tables, w=w, depth=depth,
                          levels=cuda_fold.Residuals(o, d, w, t_k, i_k, res_k))
    return out


def scene_leaf_grads(scene, ct_attrs, ct_ls) -> dict:
    """The table cotangents mapped to the scene's leaves through autograd of
    ``attribute_tables``, keyed by the leaf's position in ``scene.tensors()``."""
    from raytracer_tpu_torch.ops import cuda_fold

    leaves = [t.detach().clone().requires_grad_(True) for t in scene.tensors()]
    it = iter(leaves)

    def rebuild(node):
        return node.replace(**{
            f: rebuild(v) if hasattr(v, "tensors") else next(it)
            for f, v in vars(node).items()
        })

    attrs, ls = cuda_fold.attribute_tables(rebuild(scene))
    grads = torch.autograd.grad((attrs, ls), leaves, (ct_attrs, ct_ls), allow_unused=True)
    return {j: g for j, g in enumerate(grads) if g is not None and g.numel()}


def check_trace_whole_bwd(fwd: dict, name: str, device) -> dict:
    """The backward kernel against its plain version on the forward
    kernel's residuals and a seeded cotangent image: the 7 ray and
    throughput cotangent planes on the lanes alive at level 0, and every
    scene leaf's cotangent; then both timed with CUDA events."""
    from raytracer_tpu_torch.core.v3 import V3
    from raytracer_tpu_torch.ops import cuda_fold
    from raytracer_tpu_torch.utils.profiler import cuda_time_ms

    tables, levels, depth = fwd["tables"], fwd["levels"], fwd["depth"]
    w = fwd["w"]
    gen = torch.Generator().manual_seed(1234)
    ct = V3(*(torch.randn(w.shape, generator=gen).to(device) for _ in range(3)))
    attrs, ls = (a.detach() for a in cuda_fold.attribute_tables(fwd["scene"]))
    kern = cuda_fold.trace_whole_bwd(tables, attrs, ls, levels, ct, depth)
    plain = cuda_fold.trace_whole_bwd_reference(tables, attrs, ls, levels, ct, depth)
    alive = w > 0.0
    n_alive = int(alive.sum())
    planes = ("ct_ox", "ct_oy", "ct_oz", "ct_dx", "ct_dy", "ct_dz", "ct_w")
    k_planes, p_planes = [*kern[0], *kern[1], kern[2]], [*plain[0], *plain[1], plain[2]]
    out = dict(name=name, alive=n_alive, plane_err={}, plane_rel_err={}, exceptions=[],
               finite=True)
    n_bad = 0
    for pn, a, b in zip(planes, k_planes, p_planes):
        scale = float(b.abs().max())
        bad = alive & ~torch.isclose(a, b, rtol=1e-3, atol=1e-5 * scale)
        n_bad += int(bad.sum())
        out["plane_err"][pn] = float((a - b).abs().max())
        out["plane_rel_err"][pn] = out["plane_err"][pn] / scale if scale else out["plane_err"][pn]
        out["finite"] &= bool(torch.isfinite(a).all())
        out["exceptions"] += [
            f"  {pn} pixel ({y},{x}): kernel {float(a[y, x])!r} plain {float(b[y, x])!r}"
            for y, x in bad.nonzero().tolist()[:50]
        ]
    out["plane_exceptions"] = n_bad
    kl = scene_leaf_grads(fwd["scene"], kern[3], kern[4])
    pl = scene_leaf_grads(fwd["scene"], plain[3], plain[4])
    leaf_rel = {}
    for j, b in pl.items():
        a = kl[j]
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        leaf_rel[j] = err / scale if scale else (0.0 if err == 0.0 else float("inf"))
    out["leaf_rel_max"] = max(leaf_rel.values())
    out["leaf_scale"] = max(float(b.abs().max()) for b in pl.values())
    out["plane_scale"] = max(float(b.abs().max()) for b in p_planes)
    out["leaf_err_max"] = max(float((kl[j] - pl[j]).abs().max()) for j in pl)
    out["max_abs_err"] = max(out["leaf_err_max"], *out["plane_err"].values())
    out["max_rel_err"] = max(out["leaf_rel_max"], *out["plane_rel_err"].values())
    out["ok"] = (n_bad <= 1e-4 * n_alive and out["leaf_rel_max"] <= 1e-3 and out["finite"]
                 and set(kl) == set(pl))
    # Bytes this run's data needs: the image cotangent and the 7 output
    # planes for every lane; each level's throughput for every lane, and its
    # 6 ray planes, t and index only where the lane is alive.
    n = w.numel()
    out["bytes"] = 4 * sum(
        n + 8 * int((levels.level(k)[2] > 0).sum()) for k in range(depth + 1)
    ) + (3 + 7) * n * 4
    out["ops"] = sum(
        trace_whole_bwd_ops(tables.counts, levels.i[k].cpu().numpy(),
                            (levels.level(k)[2] > 0).cpu().numpy())
        for k in range(depth + 1)
    )
    t_bytes, t_ops = out["bytes"] / PEAK_BYTES_S, out["ops"] / PEAK_F32_S
    out["bound_ms"] = max(t_bytes, t_ops) * 1e3
    out["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    out["ms"] = statistics.median(cuda_time_ms(
        lambda: cuda_fold.trace_whole_bwd(tables, attrs, ls, levels, ct, depth),
        iters=20, warmup=3,
    ))
    out["plain_ms"] = statistics.median(cuda_time_ms(
        lambda: cuda_fold.trace_whole_bwd_reference(tables, attrs, ls, levels, ct, depth),
        iters=3, warmup=1,
    ))
    return out


def drive_main_path(device, width: int = 1920, height: int = 1080, depth: int = 3):
    """``render`` of the sprint3 scene through the public entry point, with
    every kernel's launch count set to 0 just before and read just after."""
    from raytracer_tpu_torch import render
    from raytracer_tpu_torch.models import scenes

    scene = scenes.sprint3_scene(device=device)
    camera = scenes.reference_demo_camera(device=device)
    reset_launches()
    img = render(scene, camera, width, height, depth=depth, device=device)
    if device != "cpu":
        torch.cuda.synchronize()
    return img, read_launches()


def reset_launches():
    from raytracer_tpu_torch.ops import cuda_fold

    cuda_fold.trace_whole.launches = cuda_fold.trace_whole_bwd.launches = 0


def read_launches() -> dict:
    from raytracer_tpu_torch.ops import cuda_fold

    return {"trace_whole": cuda_fold.trace_whole.launches,
            "trace_whole_bwd": cuda_fold.trace_whole_bwd.launches}


def fit_start(device, width: int = 1920, height: int = 1080):
    """The training path's inputs: the sprint3 scene with the sphere's
    center moved by +0.05 and its colour by -0.2, the camera, and the true
    scene's render as the target."""
    from raytracer_tpu_torch import default_params, merge_params, render
    from raytracer_tpu_torch.models import scenes

    scene = scenes.sprint3_scene(device=device)
    camera = scenes.reference_demo_camera(device=device)
    with torch.no_grad():
        target = render(scene, camera, width, height, depth=3, device=device)
    p = default_params(scene)
    start = merge_params(scene, {"center": p["center"] + 0.05, "color": p["color"] - 0.2})
    return start, camera, target


def drive_training_path(device, steps: int = 10, width: int = 1920,
                        height: int = 1080) -> dict:
    """``make_fit_step(1920, 1080, depth=3)`` on sprint3 through the public
    entry point: ``steps`` steps from the moved start toward the true
    scene's render, with every kernel's launch count set to 0 just before
    and read just after the run, and around each step."""
    from raytracer_tpu_torch import make_fit_step

    start, camera, target = fit_start(device, width, height)
    init_fn, step_fn = make_fit_step(width, height, depth=3, device=device)
    state = init_fn(start)
    losses, per_step = [], []
    reset_launches()
    for _ in range(steps):
        before = read_launches()
        state, loss = step_fn(state, start, camera, target)
        losses.append(float(loss))
        after = read_launches()
        per_step.append({k: after[k] - before[k] for k in after})
    if device != "cpu":
        torch.cuda.synchronize()
    launches = read_launches()
    out = dict(launches=launches, per_step=per_step, losses=losses)
    out["ok"] = (
        all(p == {"trace_whole": 1, "trace_whole_bwd": 1} for p in per_step)
        and all(np.isfinite(losses)) and losses[-1] < losses[0]
        and all(bool(torch.isfinite(v).all()) for v in state.params.values())
    )
    return out


def count_launches_demo(device) -> dict:
    """Launches of each kernel in one ``render`` of the demo at 640x640,
    depth 10 (the reference renderer's own default frame)."""
    from raytracer_tpu_torch import render
    from raytracer_tpu_torch.models import scenes

    scene = scenes.reference_demo_scene(device=device)
    camera = scenes.reference_demo_camera(device=device)
    reset_launches()
    render(scene, camera, 640, 640, depth=10, device=device)
    return read_launches()


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


def fit_breakdown(device, iters: int = 10) -> dict:
    """Median host milliseconds (each ended by a synchronize) of the parts
    of one fit step at sprint3 1920x1080 d3: ``render`` with gradients
    (attribute tables, the forward kernel with residuals, the tone map),
    the loss and its backward (the backward kernel, the tables' and tone
    map's backward), and the Adam update."""
    from raytracer_tpu_torch import make_fit_step, merge_params, render

    start, camera, target = fit_start(device)
    init_fn, _ = make_fit_step(1920, 1080, depth=3, device=device)
    state = init_fn(start)
    parts = {"render": [], "loss_backward": [], "adam": []}
    for _ in range(iters + 1):
        state.optimizer.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = render(merge_params(start, state.params), camera, 1920, 1080, depth=3,
                     device=device)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        torch.mean((img - target) ** 2).backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        state.optimizer.step()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, v in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
            parts[k].append(v * 1e3)
    return {k: statistics.median(v[1:]) for k, v in parts.items()}


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
    """On CUDA, work outside the kernels' class raises instead of falling
    back (a 65-sphere scene, with and without a leaf that requires grad, and
    depth 11), and a scene leaf that requires grad runs the gradient path:
    one launch of each kernel, and a finite, nonzero gradient."""
    from raytracer_tpu_torch import render
    from raytracer_tpu_torch.models import scenes

    camera = scenes.reference_demo_camera(device=device)

    def with_grad_radius(scene):
        radius = scene.spheres.radius.clone().requires_grad_(True)
        return scene.replace(spheres=scene.spheres.replace(radius=radius)), radius

    cases = {
        "65_spheres": (scenes.grid_sphere_scene(65, device=device), 3),
        "65_spheres_requires_grad": (with_grad_radius(scenes.grid_sphere_scene(65, device=device))[0], 3),
        "depth_11": (scenes.sprint3_scene(device=device), 11),
    }
    out = {}
    for name, (scene, depth) in cases.items():
        try:
            render(scene, camera, 32, 16, depth=depth, device=device)
            out[name] = False
        except NotImplementedError:
            out[name] = True
    scene, radius = with_grad_radius(scenes.sprint3_scene(device=device))
    reset_launches()
    img = render(scene, camera, 64, 48, depth=3, device=device)
    (g,) = torch.autograd.grad(img.sum(), radius)
    torch.cuda.synchronize()
    out["requires_grad_runs"] = (
        read_launches() == {"trace_whole": 1, "trace_whole_bwd": 1}
        and bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
    )
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from raytracer_tpu_torch.ops import _build
    from raytracer_tpu_torch.utils.profiler import (
        benchmark_fit_step,
        benchmark_forward_backward,
        benchmark_render,
    )
    from raytracer_tpu_torch.models import scenes

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.build(["trace_whole", "trace_whole_bwd"])
    print(f"build: trace_whole, trace_whole_bwd {time.perf_counter() - t0:.1f} s", flush=True)

    ok = True
    results, bwd_results = [], []
    for case in CASES:
        r = check_trace_whole(case, "cuda")
        results.append(r)
        ok &= r["ok"]
        print(
            f"trace_whole {r['name']}: ok={r['ok']} alive={r['alive']} "
            f"mismatches={r['mismatches']} t_rel_max={r['t_rel_max']:.3g} "
            f"max_abs_err={r['max_abs_err']:.3g} dead_ok={r['dead_ok']} "
            f"emit_res: same={r['emit_same']} res_mismatches={r['res_mismatches']} "
            f"ms={r['ms']:.4f} ms_res={r['ms_res']:.4f} plain_ms={r['plain_ms']:.2f} "
            f"bound_ms={r['bound_ms']:.4f} bound_res_ms={r['bound_res_ms']:.4f} "
            f"({r['bound_by']})", flush=True,
        )
        for line in r["mismatch_lines"]:
            print(line)
        b = check_trace_whole_bwd(r.pop("forward"), r["name"], "cuda")
        bwd_results.append(b)
        ok &= b["ok"]
        print(
            f"trace_whole_bwd {b['name']}: ok={b['ok']} alive={b['alive']} "
            f"plane_exceptions={b['plane_exceptions']} "
            f"plane_max_abs_err={ {k: float(f'{v:.3g}') for k, v in b['plane_err'].items()} } "
            f"leaf_rel_max={b['leaf_rel_max']:.3g} leaf_max_abs_err={b['leaf_err_max']:.3g} "
            f"max_rel_err={b['max_rel_err']:.3g} max|plain|: planes={b['plane_scale']:.3g} "
            f"leaves={b['leaf_scale']:.3g} "
            f"finite={b['finite']} ms={b['ms']:.4f} plain_ms={b['plain_ms']:.2f} "
            f"bound_ms={b['bound_ms']:.4f} ({b['bound_by']}; {b['bytes'] / 1e6:.1f} MB, "
            f"{b['ops'] / 1e9:.3g} GFLOP)", flush=True,
        )
        for line in b["exceptions"]:
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
    main, bmain = results[0], bwd_results[0]
    print(
        f"main path render sprint3 1920x1080 d3: launches={launches} ok={main_ok and im['ok']} "
        f"image={im} frame_ms={bench['frame_ms']:.4f} "
        f"rays_per_s={bench['primary_rays_per_s']:.4g} "
        f"trace_whole_ms={main['ms']:.4f} plain_ms={main['plain_ms']:.2f}", flush=True,
    )

    train = drive_training_path("cuda")
    ok &= train["ok"]
    start, camera, _ = fit_start("cuda")
    fit = benchmark_fit_step(start, camera, 1920, 1080, depth=3, iters=10)
    print(
        f"main path fit sprint3 1920x1080 d3, 10 make_fit_step steps: "
        f"launches={train['launches']} per_step={train['per_step'][0]} ok={train['ok']} "
        f"losses={[float(f'{v:.6g}') for v in train['losses']]} "
        f"step_ms={fit['step_ms']:.4f} (all {[round(v, 4) for v in fit['step_ms_all']]})",
        flush=True,
    )
    for name, scene in (("sprint3", scenes.sprint3_scene(device="cuda")),
                        ("grid64", scenes.grid_sphere_scene(64, device="cuda"))):
        fb = benchmark_forward_backward(scene, camera, 1920, 1080, depth=3, iters=10, rounds=5)
        print(
            f"forward/backward {name} 1920x1080 d3: forward_ms={fb['forward_ms']:.4f} "
            f"forward_train_ms={fb['forward_train_ms']:.4f} "
            f"forward_backward_ms={fb['forward_backward_ms']:.4f} "
            f"backward_ms={fb['backward_ms']:.4f} bwd_fwd_ratio={fb['bwd_fwd_ratio']:.4f} "
            f"ratio_rounds={[round(v, 4) for v in fb['bwd_fwd_ratio_rounds']]}", flush=True,
        )

    fbd = fit_breakdown("cuda")
    print("fit step breakdown sprint3 1920x1080 d3 (host ms, synchronized): "
          + " ".join(f"{k}={v:.4f}" for k, v in fbd.items()), flush=True)
    print(f"demo render 640x640 d10 launches per frame: {demo_launches}", flush=True)
    breakdown = frame_breakdown("cuda")
    print("frame breakdown sprint3 1920x1080 d3 (host ms, synchronized): "
          + " ".join(f"{k}={v:.4f}" for k, v in breakdown.items()), flush=True)

    guards = check_guards("cuda")
    ok &= all(guards.values())
    print(f"guards (raise on CUDA, gradient path runs): {guards}", flush=True)

    kernels = [{
        "name": "trace_whole", "route": "cuda",
        "source": "raytracer_tpu_torch/csrc/trace_whole.cu",
        "replaces": "raytracer_tpu/ops/pallas_fold.py:1795",
        "launches": launches["trace_whole"],
        "launches_by_path": {"render": launches["trace_whole"],
                             "fit_10_steps": train["launches"]["trace_whole"]},
        "max_abs_err": max(r["max_abs_err"] for r in results),
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "ms_emit_res": main["ms_res"], "bound_emit_res_ms": main["bound_res_ms"],
        "library_ms": None,
        "check": all(r["ok"] for r in results),
    }, {
        "name": "trace_whole_bwd", "route": "cuda",
        "source": "raytracer_tpu_torch/csrc/trace_whole_bwd.cu",
        "replaces": "raytracer_tpu/ops/pallas_fold.py:2635",
        "launches": train["launches"]["trace_whole_bwd"],
        "launches_by_path": {"render": launches["trace_whole_bwd"],
                             "fit_10_steps": train["launches"]["trace_whole_bwd"]},
        "max_abs_err": bmain["max_abs_err"],
        "max_rel_err_all_cases": max(b["max_rel_err"] for b in bwd_results),
        "ms": bmain["ms"], "plain_ms": bmain["plain_ms"],
        "bound_ms": bmain["bound_ms"], "bound_by": bmain["bound_by"],
        "library_ms": None,
        "check": all(b["ok"] for b in bwd_results),
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
