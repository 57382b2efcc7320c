#!/usr/bin/env python3
"""Build the port's CUDA kernels and drive its main paths on one GPU.

    python3 chip_smoke.py

Phases, one line each: the card's name and power limit; the build of the
five kernels from csrc/ (one nvcc each, started together); the whole-trace
kernels against their plain PyTorch versions on their five workloads (the
forward with and without its residual planes, the backward on the forward's
residuals); the per-level kernels (ray_stats, trace_level,
trace_level_bwd) against theirs on four workloads, level by level on the
same inputs and shortlists, then the chain end to end and its backward; a
sweep of tile shapes and the whole-vs-per-level times; the small-scene
render path (``render`` of sprint3 at 1920x1080, depth 3) and its training
path (10 ``make_fit_step`` steps); the large-scene render path (``render``
of grid-1024 at 1920x1080, depth 3, and at 3840x2160, depth 4) and its
training path (5 steps at 1920x1080, depth 3), each path with the kernel
launch counts set to 0 just before it and read just after; the frame, fit
step and forward/backward times and breakdowns; a profile of one frame; the
guards; a ``kernels`` JSON line. The last line is ``{"ok": true, "device":
{...}}``. Any failed check ends the run with a non-zero exit code and no
result line. Without CUDA, or without the package beside it, it exits
non-zero at once.
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
# the main path's shape; the fifth has a ragged end (n % 256 != 0); the last
# is a 16-chunk scene of the widened fused class. These are the whole-trace
# kernels' workloads.
CASES = (
    ("sprint3_1920x1080_d3", ("sprint3_scene", ()), 1920, 1080, 3),
    ("demo_640x640_d10", ("reference_demo_scene", ()), 640, 640, 10),
    ("grid64_1920x1080_d3", ("grid_sphere_scene", (64,)), 1920, 1080, 3),
    ("mixed_256x128_d2", ("mixed_primitive_scene", ()), 256, 128, 2),
    ("sprint3_333x111_d3", ("sprint3_scene", ()), 333, 111, 3),
    ("grid512_640x360_d3", ("grid_sphere_scene", (512,)), 640, 360, 3),
)

# The per-level chain's workloads. The first is the main path's shape:
# grid-1024, the scene of BASELINE config c5 and bench.py's large frame, at
# 1920x1080 d3. Then ragged tiles on a 9-chunk scene, boxes and 5 chunks,
# and identity lists (one chunk) at a depth past the whole-trace class.
LEVEL_CASES = (
    ("grid1024_1920x1080_d3", ("grid_sphere_scene", (1024,)), 1920, 1080, 3),
    ("grid130_333x111_d3", ("grid_sphere_scene", (130,)), 333, 111, 3),
    ("grid80boxes_256x128_d2", ("grid80_boxes", ()), 256, 128, 2),
    ("demo_640x640_d12", ("reference_demo_scene", ()), 640, 640, 12),
)
# Tile shapes (rows, cols) of the per-level kernels' sweep: one block each.
TILES = ((8, 32), (16, 16), (4, 64), (2, 128))


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


def make_scene(spec, device):
    """A workload's scene: a factory of models/scenes.py, or grid-80 with
    the mixed scene's two boxes."""
    from raytracer_tpu_torch.models import scenes

    factory, args = spec
    if factory == "grid80_boxes":
        grid = scenes.grid_sphere_scene(80, device=device)
        return grid.replace(boxes=scenes.mixed_primitive_scene(device=device).boxes)
    return getattr(scenes, factory)(*args, device=device)


def frame_rays(width: int, height: int, device):
    """The demo camera's primary rays as seven contiguous planes."""
    from raytracer_tpu_torch.models import scenes
    from raytracer_tpu_torch.ops.trace import raygen_tile

    o, d = raygen_tile(scenes.reference_demo_camera(device=device), width, height)
    o, d = o.broadcast_to(d.x.shape), d.broadcast_to(d.x.shape)
    return o, d, torch.ones(d.x.shape, dtype=torch.float32, device=device)


def ray_stats_ops(n_c: int, alive: np.ndarray, used: np.ndarray) -> float:
    """Float32 operations of the stats of these lanes, reckoned from
    trace_common.cuh's `tile_stats` as ``trace_whole_ops`` is: the safe
    reciprocals and the slab clip for an alive lane (34), the segment ends,
    box and sums for a used lane (22) and the chunk gate for each chunk
    (25), and the reduction: one combine per value and lane (10 per
    lane)."""
    return float(34 * alive.sum() + (22 + 25 * n_c) * used.sum() + 10 * alive.size)


def used_lanes(tables, o, d, w) -> torch.Tensor:
    """Lanes that are alive and meet the sphere slab."""
    from raytracer_tpu_torch.ops import cuda_fold

    iv = tuple(cuda_fold._srecip(c) for c in d)
    return (w > 0) & cuda_fold._slab_segment(tables.cols, o, iv)[2]


def trace_level_ops(tables, listed: np.ndarray, idx: np.ndarray, alive: np.ndarray,
                    used: np.ndarray, next_used) -> float:
    """Float32 operations of one level on this run's data, reckoned from
    csrc/trace_level.cu as ``trace_whole_ops`` is: per alive lane the walls,
    boxes and sky, the slab clip and every chunk of its tile's list gated
    (used lanes), the spheres of one chunk where the winner is a sphere (the
    least a lane that hits one folds), the winner's record and shading; and
    the next level's stats (``ray_stats_ops``) where the level writes them.
    A lower bound: a lane may fold more chunks than its winner's."""
    c = tables.counts
    n_s, n_w, n_b = c["n_s"], c["n_w"], c["n_b"]
    gate = 26 if c["gate"] == 0 else 24
    ops = float((19 + 39 * n_w + 25 * n_b + 14) * alive.sum())
    if n_s:
        ops += float((25 * used + gate * listed * used).sum())
        ops += 22.0 * min(c["unroll"], n_s) * (alive & (idx >= 0) & (idx < n_s)).sum()
    shade = 49 * c["n_pt"] + 36 * c["n_sun"] + 35
    for rec, lo, hi in ((38, 0, n_s), (22, n_s, n_s + n_w), (39, n_s + n_w, n_s + n_w + n_b)):
        ops += float(rec + shade) * (alive & (idx >= lo) & (idx < hi)).sum()
    ops += 6.0 * (alive & (idx < 0)).sum()
    if next_used is not None:
        ops += ray_stats_ops(c["n_c"], next_used[0], next_used[1])
    return ops


def plain_chain(tables, o, d, w, depth: int, tile=None):
    """The per-level chain through the kernels' plain versions on the
    rays' device: ``(rgb V3, t, index)``."""
    from raytracer_tpu_torch.core.v3 import V3
    from raytracer_tpu_torch.ops import cuda_level

    per_tile = cuda_level.uses_shortlists(tables)
    stats = cuda_level.ray_stats_reference(tables, o, d, w, tile) if per_tile else None
    zero = torch.zeros_like(w)
    acc = V3(zero, zero, zero)
    ts, idxs = [], []
    for k in range(depth + 1):
        sl = cuda_level.phase_a(stats, tables) if per_tile else None
        t_k, i_k, acc, w, o, d, stats = cuda_level.trace_level_reference(
            tables, sl, o, d, w, acc, k == depth, tile, per_tile and k < depth
        )
        ts.append(t_k)
        idxs.append(i_k)
    return acc, torch.stack(ts), torch.stack(idxs)


def exact_stats(stats: torch.Tensor) -> torch.Tensor:
    """The columns of a stats row that the kernel and its plain version
    compute exactly: the box, the count, the alive flag, the reach bits."""
    return torch.cat([stats[:, :6], stats[:, 9:]], dim=1)


def accepted(shortlist) -> torch.Tensor:
    """[tiles, n_c] bool: the chunks each tile's list holds."""
    chunk_list, counts = shortlist
    n_c = chunk_list.shape[1]
    pos = torch.arange(n_c, device=chunk_list.device)
    mask = torch.zeros(chunk_list.shape, dtype=torch.bool, device=chunk_list.device)
    return mask.scatter_(1, chunk_list.long(), pos[None] < counts[:, None].clamp_min(0))


def check_levels(case, device, timed: bool = False, tile=None) -> dict:
    """The per-level kernels against their plain versions on one workload.

    Kernel 3 (``ray_stats``) against ``ray_stats_reference`` on the frame's
    rays, and the shortlists phase A builds from each; then each level of
    the kernel chain's own run: ``trace_level`` and ``trace_level_reference``
    on the same input rays and the same shortlist (selections, t,
    accumulator, next rays and next stats must be bit-identical); the
    kernel chain end to end against the plain chain; the per-level backward
    (``trace_levels_bwd``, kernel 5) against the whole-trace backward's plain
    version on the kernel chain's residuals. With ``timed``, each kernel's
    device time per launch, its plain version's, and the bounds of this
    run's data."""
    from raytracer_tpu_torch.core.v3 import V3
    from raytracer_tpu_torch.ops import cuda_fold, cuda_level
    from raytracer_tpu_torch.ops.trace import MISS_T

    name, spec, width, height, depth = case
    scene = make_scene(spec, device)
    o, d, w = frame_rays(width, height, device)
    tables = cuda_fold.fused_tables(scene)
    per_tile = cuda_level.uses_shortlists(tables)
    n_c = tables.counts["n_c"]
    out = dict(name=name, shape=(height, width), depth=depth, n_c=n_c, per_tile=per_tile,
               smem_table=tables.smem_bytes, listed=[])
    ok = True
    if per_tile:
        ks = cuda_level.ray_stats(tables, o, d, w, tile)
        ps = cuda_level.ray_stats_reference(tables, o, d, w, tile)
        out["stats_exact"] = torch.equal(exact_stats(ks), exact_stats(ps))
        scale = float(ps[:, 6:9].abs().max())
        out["stats_sum_abs"] = float((ks[:, 6:9] - ps[:, 6:9]).abs().max())
        out["stats_sum_rel"] = out["stats_sum_abs"] / max(scale, 1e-30)
        slk, slp = cuda_level.phase_a(ks, tables), cuda_level.phase_a(ps, tables)
        out["shortlists_same"] = (torch.equal(slk[1], slp[1])
                                  and torch.equal(accepted(slk), accepted(slp)))
        ok &= out["stats_exact"] and out["stats_sum_rel"] <= 1e-5 and out["shortlists_same"]

    rgb_k, t_k, i_k, res_k = cuda_level.trace_levels(tables, o, d, w, depth, emit_res=True,
                                                     tile=tile)
    levels = cuda_fold.Residuals(o, d, w, t_k, i_k, res_k)
    stats = cuda_level.ray_stats(tables, o, d, w, tile) if per_tile else None
    zero = torch.zeros_like(w)
    acc = V3(zero, zero, zero)
    level_bad = []
    for k in range(depth + 1):
        lo, ld, lw = levels.level(k)
        last = k == depth
        sl = cuda_level.phase_a(stats, tables) if per_tile else None
        if sl is not None:
            out["listed"].append(float(sl[1].clamp_min(0).float().mean()))
        want_stats = per_tile and not last
        pt, pi, pacc, pw, po, pd, pst = cuda_level.trace_level_reference(
            tables, sl, lo, ld, lw, acc, last, tile, want_stats
        )
        tt, ii = torch.empty_like(w), torch.empty(w.shape, dtype=torch.int32, device=device)
        nxt = None if last else [torch.empty_like(w) for _ in range(7)]
        kacc = V3(*(a.clone() for a in acc))
        kst = cuda_level.trace_level(tables, sl, lo, ld, lw, kacc, tt, ii, nxt, last, tile,
                                     want_stats)
        same = {
            "i": torch.equal(ii, pi) and torch.equal(ii, i_k[k]),
            "t": torch.equal(tt, pt) and torch.equal(tt, t_k[k]),
            "acc": all(torch.equal(a, b) for a, b in zip(kacc, pacc)),
        }
        if not last:
            same["next"] = all(torch.equal(a, b) for a, b in zip(nxt, (*po, *pd, pw)))
            same["res"] = torch.equal(torch.stack(nxt), res_k[k])
        if want_stats:
            same["stats"] = torch.equal(exact_stats(kst), exact_stats(pst))
        level_bad += [f"level {k} {key}" for key, v in same.items() if not v]
        acc, stats = pacc, kst
    out["levels_bad"] = level_bad
    ok &= not level_bad

    # The chain end to end against the plain chain (whose shortlists come
    # from the plain stats).
    rgb_p, t_p, i_p = plain_chain(tables, o, d, w, depth, tile)
    alive = alive_levels(tables, i_p)
    mism = alive & (i_k != i_p)
    n_alive = int(alive.sum())
    clean = ~mism.any(dim=0)
    close = torch.stack([torch.isclose(a, b, rtol=1e-4, atol=1e-5)
                         for a, b in zip(rgb_k, rgb_p)])[:, clean]
    dead = ~alive
    out.update(
        alive=n_alive, chain_mismatches=int(mism.sum()),
        chain_max_abs_err=float(torch.stack([(a - b).abs() for a, b in zip(rgb_k, rgb_p)])
                                [:, clean].max()),
        chain_rgb_ok=bool(close.all()),
        dead_ok=bool(((i_k[dead] == -1) & (t_k[dead] == MISS_T)).all()),
        finite=all(bool(torch.isfinite(c).all()) for c in rgb_k),
    )
    ok &= (out["chain_mismatches"] <= 1e-5 * n_alive and out["chain_rgb_ok"]
           and out["dead_ok"] and out["finite"])

    # The backward on the kernel chain's residuals.
    gen = torch.Generator().manual_seed(1234)
    ct = V3(*(torch.randn(w.shape, generator=gen).to(device) for _ in range(3)))
    attrs, ls = (a.detach() for a in cuda_fold.attribute_tables(scene))
    kern = cuda_level.trace_levels_bwd(tables, attrs, ls, levels, ct, depth)
    plain = cuda_fold.trace_whole_bwd_reference(tables, attrs, ls, levels, ct, depth)
    n_bad, plane_rel = 0, []
    for a, b in zip((*kern[0], *kern[1], kern[2]), (*plain[0], *plain[1], plain[2])):
        scale = float(b.abs().max())
        n_bad += int((~torch.isclose(a, b, rtol=1e-3, atol=1e-5 * scale)).sum())
        plane_rel.append(float((a - b).abs().max()) / scale if scale else 0.0)
        out["finite"] &= bool(torch.isfinite(a).all())
    kl = scene_leaf_grads(scene, kern[3], kern[4])
    pl = scene_leaf_grads(scene, plain[3], plain[4])
    leaf_rel = [float((kl[j] - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                for j, b in pl.items()]
    out.update(
        bwd_plane_exceptions=n_bad, bwd_plane_rel_max=max(plane_rel),
        bwd_leaf_rel_max=max(leaf_rel), bwd_leaf_scale=max(float(b.abs().max()) for b in pl.values()),
        bwd_plane_scale=max(float(b.abs().max()) for b in (*plain[0], *plain[1], plain[2])),
        bwd_max_abs_err=max(float((kl[j] - b).abs().max()) for j, b in pl.items()),
    )
    out["bwd_ok"] = (n_bad <= 1e-4 * w.numel() and out["bwd_leaf_rel_max"] <= 1e-3
                     and set(kl) == set(pl) and out["finite"])
    ok &= out["bwd_ok"]
    out["ok"] = ok
    if not timed:
        return out

    # Times and bounds: one launch at a time on the chain's own inputs. The
    # bytes are those the function must move on this run's data: every lane
    # reads its ray and throughput and writes (t, index) and, below the last
    # level, its next ray and throughput; only an alive lane reads and
    # writes the accumulator. A tile's shortlist is its count and its
    # accepted entries; the stats are one row per tile.
    n = w.numel()
    np_i = i_k.cpu().numpy()
    out["bwd_ms"], out["bwd_bound_ms"], out["bwd_plain_ms"] = [], [], []
    (tr, tc), th, tw = cuda_level.tile_grid(w.shape, tile)
    tid = (torch.arange(height, device=device)[:, None] // tr * tw
           + torch.arange(width, device=device)[None, :] // tc)
    row = th * tw * (cuda_level.NSTAT + n_c)
    km = level_kernels_ms(tables, o, d, w, depth, tile, plain=True)
    out.update(stats_ms=km["stats_ms"], level_ms=km["level_ms"],
               level_plain_ms=km["level_plain_ms"], level_bound_ms=[])
    if per_tile:
        used0 = used_lanes(tables, o, d, w)
        out["stats_plain_ms"] = km["stats_plain_ms"]
        b_bytes = (7 * n + row) * 4
        b_ops = ray_stats_ops(n_c, (w > 0).cpu().numpy(), used0.cpu().numpy())
        out["stats_bound_ms"] = max(b_bytes / PEAK_BYTES_S, b_ops / PEAK_F32_S) * 1e3
        out["stats_bound_by"] = "bytes" if b_bytes / PEAK_BYTES_S >= b_ops / PEAK_F32_S else "operations"
    by_ops = []
    for k, (lo, ld, lw, sl, want_stats) in enumerate(km["inputs"]):
        last = k == depth
        lw_np = (lw > 0).cpu().numpy()
        used = used_lanes(tables, lo, ld, lw).cpu().numpy()
        listed = (sl[1].clamp_min(0)[tid].cpu().numpy() if sl is not None
                  else np.full(lw_np.shape, n_c))
        nu = None
        if want_stats:
            nu = ((res_k[k, 6] > 0).cpu().numpy(),
                  used_lanes(tables, V3(*res_k[k, :3]), V3(*res_k[k, 3:6]), res_k[k, 6]).cpu().numpy())
        ops = trace_level_ops(tables, listed, np_i[k], lw_np, used, nu)
        bts = 4 * ((9 if last else 16) * n + 6 * int(lw_np.sum()) + (row if want_stats else 0)
                   + (th * tw + int(sl[1].clamp_min(0).sum()) if sl is not None else 0))
        out["level_bound_ms"].append(max(bts / PEAK_BYTES_S, ops / PEAK_F32_S) * 1e3)
        by_ops.append(ops / PEAK_F32_S > bts / PEAK_BYTES_S)
    out["level_bound_by"] = "operations" if all(by_ops) else ("bytes" if not any(by_ops) else "mixed")
    # The backward, level by level, on the cotangents its chain passes down.
    sums = (torch.zeros(attrs.shape, dtype=torch.float64, device=device),
            torch.zeros(ls.shape, dtype=torch.float64, device=device))
    cts = [None]
    for k in reversed(range(depth + 1)):
        lo, ld, lw = levels.level(k)
        cts.insert(0, cuda_level.trace_level_bwd(tables, attrs, ls, lo, ld, lw, t_k[k], i_k[k],
                                                 ct, cts[0], k == depth, sums))
    ops_b = []
    for k in range(depth + 1):
        lo, ld, lw = levels.level(k)
        cn = cts[k + 1]
        out["bwd_ms"].append(event_ms(
            lambda: cuda_level.trace_level_bwd(tables, attrs, ls, lo, ld, lw, t_k[k], i_k[k],
                                               ct, cn, k == depth, sums)))
        out["bwd_plain_ms"].append(event_ms(
            lambda: cuda_level.trace_level_bwd_reference(tables, attrs, ls, lo, ld, lw, t_k[k],
                                                         i_k[k], ct, cn, k == depth, sums),
            iters=2, warmup=1))
        a_k = (lw > 0).cpu().numpy()
        n_win = len(np.unique(np_i[k][a_k & (np_i[k] >= 0)]))
        bts = 4 * ((1 + 7 + (0 if k == depth else 7)) * n + 11 * int(a_k.sum())) + 8 * 14 * n_win
        ops = trace_whole_bwd_ops(tables.counts, np_i[k], a_k)
        out["bwd_bound_ms"].append(max(bts / PEAK_BYTES_S, ops / PEAK_F32_S) * 1e3)
        ops_b.append(ops / PEAK_F32_S > bts / PEAK_BYTES_S)
    out["bwd_bound_by"] = "operations" if all(ops_b) else ("bytes" if not any(ops_b) else "mixed")
    out["chain_ms"] = event_ms(lambda: cuda_level.trace_levels(tables, o, d, w, depth, tile=tile),
                               iters=10, warmup=2)
    return out


def event_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device milliseconds of one call of ``fn`` (CUDA events)."""
    from raytracer_tpu_torch.utils.profiler import cuda_time_ms

    return statistics.median(cuda_time_ms(fn, iters=iters, warmup=warmup))


def host_ms(steps: dict, iters: int) -> dict:
    """Median host milliseconds of each step of ``steps`` (name -> call),
    each call ended by a synchronize, after one warm-up call."""
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


def level_kernels_ms(tables, o, d, w, depth: int, tile=None, plain: bool = False) -> dict:
    """The per-level kernels of one frame, each timed alone on the chain's
    own inputs (``event_ms``): ``ray_stats`` and each ``trace_level``
    launch, their sum, the mean listed chunks per level, and each level's
    inputs ``(o, d, w, shortlist, want_stats)``. With ``plain``, also the
    plain versions' times on the same inputs."""
    from raytracer_tpu_torch.core.v3 import V3
    from raytracer_tpu_torch.ops import cuda_fold, cuda_level

    _, t_k, i_k, res = cuda_level.trace_levels(tables, o, d, w, depth, emit_res=True, tile=tile)
    levels = cuda_fold.Residuals(o, d, w, t_k, i_k, res)
    per_tile = cuda_level.uses_shortlists(tables)
    out = dict(stats_ms=0.0, level_ms=[], level_plain_ms=[], listed=[], inputs=[])
    stats = None
    if per_tile:
        out["stats_ms"] = event_ms(lambda: cuda_level.ray_stats(tables, o, d, w, tile))
        if plain:
            out["stats_plain_ms"] = event_ms(
                lambda: cuda_level.ray_stats_reference(tables, o, d, w, tile), iters=3, warmup=1)
        stats = cuda_level.ray_stats(tables, o, d, w, tile)
    for k in range(depth + 1):
        lo, ld, lw = levels.level(k)
        last = k == depth
        sl = cuda_level.phase_a(stats, tables) if per_tile else None
        if sl is not None:
            out["listed"].append(float(sl[1].clamp_min(0).float().mean()))
        tt = torch.empty_like(w)
        ii = torch.empty(w.shape, dtype=torch.int32, device=w.device)
        nxt = None if last else [torch.empty_like(w) for _ in range(7)]
        acc = V3(*(torch.zeros_like(w) for _ in range(3)))
        want = per_tile and not last

        def launch():
            return cuda_level.trace_level(tables, sl, lo, ld, lw, acc, tt, ii, nxt, last, tile,
                                          want)

        out["level_ms"].append(event_ms(launch))
        if plain:
            out["level_plain_ms"].append(event_ms(
                lambda: cuda_level.trace_level_reference(tables, sl, lo, ld, lw, acc, last, tile,
                                                         want), iters=2, warmup=1))
        out["inputs"].append((lo, ld, lw, sl, want))
        stats = launch()
    out["sum_ms"] = out["stats_ms"] + sum(out["level_ms"])
    return out


def tile_sweep(device, case=LEVEL_CASES[0]) -> list:
    """The main path's frame through the per-level kernels at each tile
    shape of ``TILES`` (``level_kernels_ms``)."""
    from raytracer_tpu_torch.ops import cuda_fold

    name, spec, width, height, depth = case
    tables = cuda_fold.fused_tables(make_scene(spec, device))
    o, d, w = frame_rays(width, height, device)
    return [dict(tile=tile, **level_kernels_ms(tables, o, d, w, depth, tile)) for tile in TILES]


def whole_vs_levels(device) -> list:
    """Grids of 64 to 768 spheres (4 to 24 chunks; the largest table that
    fits the whole-trace kernels' 48 KB) at 1920x1080 d3 through both
    routes: the selections of the two routes' kernels against each other;
    forward, the whole-trace kernel's time against the per-level kernels'
    summed device times (``level_kernels_ms``) and each route's call as a
    caller sees it (CUDA events, nothing queued ahead, host work included);
    backward, the whole-trace backward kernel against the per-level
    backward chain, on each route's own residuals and one image
    cotangent."""
    from raytracer_tpu_torch.core.v3 import V3
    from raytracer_tpu_torch.ops import cuda_fold, cuda_level
    from raytracer_tpu_torch.utils.profiler import _calls_ms

    rows = []
    for n in (64, 130, 256, 512, 768):
        scene = make_scene(("grid_sphere_scene", (n,)), device)
        tables = cuda_fold.fused_tables(scene)
        o, d, w = frame_rays(1920, 1080, device)
        _, t_w, i_w, res_w = cuda_fold.trace_whole(tables, o, d, w, 3, emit_res=True)
        _, t_l, i_l, res_l = cuda_level.trace_levels(tables, o, d, w, 3, emit_res=True)
        alive = alive_levels(tables, i_w)
        same = i_w == i_l
        attrs, ls = (a.detach() for a in cuda_fold.attribute_tables(scene))
        gen = torch.Generator().manual_seed(7)
        ct = V3(*(torch.randn(w.shape, generator=gen).to(device) for _ in range(3)))
        lv_w = cuda_fold.Residuals(o, d, w, t_w, i_w, res_w)
        lv_l = cuda_fold.Residuals(o, d, w, t_l, i_l, res_l)
        rows.append(dict(
            name=f"grid{n}", n_c=tables.counts["n_c"], table_bytes=tables.smem_bytes,
            alive=int(alive.sum()), mismatches=int((alive & ~same).sum()),
            t_equal=bool(torch.equal(t_w[same], t_l[same])),
            whole_ms=event_ms(lambda: cuda_fold.trace_whole(tables, o, d, w, 3)),
            kernels=level_kernels_ms(tables, o, d, w, 3),
            whole_call_ms=_calls_ms(lambda: cuda_fold.trace_whole(tables, o, d, w, 3), 10),
            levels_call_ms=_calls_ms(lambda: cuda_level.trace_levels(tables, o, d, w, 3), 10),
            whole_bwd_ms=event_ms(
                lambda: cuda_fold.trace_whole_bwd(tables, attrs, ls, lv_w, ct, 3),
                iters=10, warmup=2),
            levels_bwd_call_ms=_calls_ms(
                lambda: cuda_level.trace_levels_bwd(tables, attrs, ls, lv_l, ct, 3), 10),
        ))
    return rows


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


def _counted():
    from raytracer_tpu_torch.ops import cuda_fold, cuda_level

    return {"trace_whole": cuda_fold.trace_whole, "trace_whole_bwd": cuda_fold.trace_whole_bwd,
            "ray_stats": cuda_level.ray_stats, "trace_level": cuda_level.trace_level,
            "trace_level_bwd": cuda_level.trace_level_bwd}


def reset_launches():
    for fn in _counted().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in _counted().items()}


def launches_of(**counts) -> dict:
    """Every kernel's count: the given ones, 0 for the others."""
    return {name: counts.get(name, 0) for name in _counted()}


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
        all(p == launches_of(trace_whole=1, trace_whole_bwd=1) for p in per_step)
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
    return host_ms(steps, iters)


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
    """On CUDA, work outside the whole-trace class runs the per-level
    kernels (the 1024-sphere grid, with and without a leaf that requires
    grad, and depth 11, each with its launch counts), a scene leaf that requires
    grad in the class runs the whole-trace gradient path (one launch of each
    kernel, a finite, nonzero gradient), and a launch the kernel refuses
    raises."""
    from raytracer_tpu_torch import render
    from raytracer_tpu_torch.core.v3 import V3
    from raytracer_tpu_torch.models import scenes
    from raytracer_tpu_torch.ops import cuda_fold, cuda_level

    camera = scenes.reference_demo_camera(device=device)

    def with_grad_radius(scene):
        radius = scene.spheres.radius.clone().requires_grad_(True)
        return scene.replace(spheres=scene.spheres.replace(radius=radius)), radius

    out = {}
    reset_launches()
    img = render(scenes.grid_sphere_scene(1024, device=device), camera, 32, 16, depth=3,
                 device=device)
    torch.cuda.synchronize()
    out["1024_spheres_per_level"] = (read_launches() == launches_of(ray_stats=1, trace_level=4)
                                     and bool(torch.isfinite(img).all()))
    scene, radius = with_grad_radius(scenes.grid_sphere_scene(1024, device=device))
    reset_launches()
    img = render(scene, camera, 32, 16, depth=3, device=device)
    (g,) = torch.autograd.grad(img.sum(), radius)
    torch.cuda.synchronize()
    out["1024_spheres_requires_grad_per_level"] = (
        read_launches() == launches_of(ray_stats=1, trace_level=4, trace_level_bwd=4)
        and bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
    )
    reset_launches()
    img = render(scenes.sprint3_scene(device=device), camera, 32, 16, depth=11, device=device)
    torch.cuda.synchronize()
    out["depth_11_per_level"] = (read_launches() == launches_of(trace_level=12)
                                 and bool(torch.isfinite(img).all()))
    scene, radius = with_grad_radius(scenes.sprint3_scene(device=device))
    reset_launches()
    img = render(scene, camera, 64, 48, depth=3, device=device)
    (g,) = torch.autograd.grad(img.sum(), radius)
    torch.cuda.synchronize()
    out["requires_grad_runs"] = (
        read_launches() == launches_of(trace_whole=1, trace_whole_bwd=1)
        and bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
    )
    # A tile of 128 threads is not a block of the kernel: the launch is
    # refused and the wrapper raises.
    tables = cuda_fold.fused_tables(scenes.grid_sphere_scene(1024, device=device))
    o, d, w = frame_rays(32, 16, device)
    try:
        cuda_level.trace_level(tables, None, o, d, w, V3(*(torch.zeros_like(w),) * 3),
                               torch.empty_like(w), torch.empty(w.shape, dtype=torch.int32,
                                                                device=device),
                               None, True, tile=(8, 16))
        out["refused_launch_raises"] = False
    except RuntimeError:
        out["refused_launch_raises"] = True
    return out


def drive_level_path(device, width: int = 1920, height: int = 1080, depth: int = 3):
    """``render`` of grid-1024 through the public entry point (the
    per-level route), with every kernel's launch count set to 0 just before
    and read just after."""
    from raytracer_tpu_torch import render
    from raytracer_tpu_torch.models import scenes

    scene = scenes.grid_sphere_scene(1024, device=device)
    camera = scenes.reference_demo_camera(device=device)
    reset_launches()
    img = render(scene, camera, width, height, depth=depth, device=device)
    torch.cuda.synchronize()
    return img, read_launches()


def image_stats(img) -> dict:
    """Pixels of a tone-mapped image that are not finite, and that are above
    1 (the tone map divides by 1 + luma, so a firefly of one saturated
    colour, radiance 1e13 and more from the hard renderer's grazing bounces,
    PERF.md, maps above 1 in that channel), the largest finite value, and
    whether the finite ones are >= 0."""
    finite = torch.isfinite(img).all(dim=-1)
    return dict(
        shape=tuple(img.shape), nonfinite=int((~finite).sum()),
        above_1=int((img[finite] > 1).any(dim=-1).sum()),
        max=float(img[finite].max()), range_ok=bool((img[finite] >= 0).all()),
        mean=float(img[finite].mean()),
    )


def check_level_image(img, width, height, device) -> dict:
    """The right shape, finite and >= 0 but for at most 1e-5 of the pixels
    (non-finite fireflies), and on a small frame: equal to the plain
    chain's render from the same rays on the card on >= 99.9% of pixels
    (their shortlists may list chunks in another order where the stats' sums
    round apart, which matters only for a direction a grazing bounce left
    non-unit), and close to the CPU render on >= 95% of pixels (the CPU's
    rsqrt in ray generation differs from the card's in the last bit; a
    one-ulp change of the directions alone moves 2.4% of this frame's
    pixels past 1e-4 on grid-1024, whose mirror spheres multiply it)."""
    from raytracer_tpu_torch import render
    from raytracer_tpu_torch.models import scenes
    from raytracer_tpu_torch.ops import cuda_fold
    from raytracer_tpu_torch.ops.tonemap import reinhard_tonemap

    out = image_stats(img)
    out["shape_ok"] = out["shape"] == (height, width, 3)
    out["finite_ok"] = out["nonfinite"] <= 1e-5 * width * height
    scene = scenes.grid_sphere_scene(1024, device=device)
    small = render(scene, scenes.reference_demo_camera(device=device), 96, 64, depth=3,
                   device=device)
    o, d, w = frame_rays(96, 64, device)
    rgb, _, _ = plain_chain(cuda_fold.fused_tables(scene), o, d, w, 3)
    out["small_plain_equal_frac"] = float(
        (small == reinhard_tonemap(rgb.stacked())).all(dim=-1).float().mean())
    cpu = render(scenes.grid_sphere_scene(1024, device="cpu"),
                 scenes.reference_demo_camera(device="cpu"), 96, 64, depth=3, device="cpu")
    close = torch.isclose(small.cpu(), cpu, rtol=1e-4, atol=1e-4).all(dim=-1)
    out["small_cpu_close_frac"] = float(close.float().mean())
    out["ok"] = (out["shape_ok"] and out["finite_ok"] and out["range_ok"]
                 and out["small_plain_equal_frac"] >= 0.999 and out["small_cpu_close_frac"] >= 0.95)
    return out


def level_fit_start(device, width: int = 1920, height: int = 1080):
    """The large-scene training path's inputs: grid-1024 with every
    sphere's colour lowered by 0.2 (and held at 0 or above: the colours
    start in [0.1, 1), and a negative colour turns the hard renderer's
    fireflies into radiance of -1e13, which the tone map passes through)
    and the centers true, the camera, and the true scene's render as the
    target."""
    from raytracer_tpu_torch import default_params, merge_params, render
    from raytracer_tpu_torch.models import scenes

    scene = scenes.grid_sphere_scene(1024, device=device)
    camera = scenes.reference_demo_camera(device=device)
    with torch.no_grad():
        target = render(scene, camera, width, height, depth=3, device=device)
    p = default_params(scene)
    start = merge_params(scene, {"center": p["center"],
                                 "color": torch.clamp_min(p["color"] - 0.2, 0.0)})
    return start, camera, target


def level_fit_optimizer(params: dict) -> torch.optim.Optimizer:
    """Adam with optax's defaults, the colours at 2e-2 and the centers at
    1e-4: the centers start at the truth, where the hard renderer's
    geometry gradient cannot lower the loss (it has no silhouette term, and
    a step of the default size moves 1024 silhouettes by pixels), yet they
    stay parameters, so their gradient runs through the backward kernel."""
    return torch.optim.Adam([{"params": [params["color"]], "lr": 2e-2},
                             {"params": [params["center"]], "lr": 1e-4}],
                            betas=(0.9, 0.999), eps=1e-8)


def drive_level_training(device, steps: int = 5, width: int = 1920,
                         height: int = 1080) -> dict:
    """``make_fit_step(1920, 1080, depth=3)`` on grid-1024 through the
    public entry point (``default_params``: centers and colours; Adam per
    ``level_fit_optimizer``): ``steps`` steps from the lowered colours
    toward the true render, with every kernel's launch count set to 0 just
    before and read just after the run, and around each step; the largest
    sphere-center and colour gradient of each step."""
    from raytracer_tpu_torch import make_fit_step

    start, camera, target = level_fit_start(device, width, height)
    init_fn, step_fn = make_fit_step(width, height, depth=3, device=device,
                                     optimizer=level_fit_optimizer)
    state = init_fn(start)
    losses, per_step, g_center, g_color = [], [], [], []
    reset_launches()
    for _ in range(steps):
        before = read_launches()
        state, loss = step_fn(state, start, camera, target)
        losses.append(float(loss))
        after = read_launches()
        per_step.append({k: after[k] - before[k] for k in after})
        g_center.append(float(state.params["center"].grad.abs().max()))
        g_color.append(float(state.params["color"].grad.abs().max()))
    torch.cuda.synchronize()
    out = dict(launches=read_launches(), per_step=per_step, losses=losses,
               grad_center_max=g_center, grad_color_max=g_color)
    out["ok"] = (
        all(p == launches_of(ray_stats=1, trace_level=4, trace_level_bwd=4) for p in per_step)
        and all(np.isfinite(losses)) and losses[-1] < losses[0]
        and all(bool(torch.isfinite(v).all()) for v in state.params.values())
    )
    return out


def level_frame_breakdown(device, width: int = 1920, height: int = 1080, depth: int = 3,
                          iters: int = 20) -> dict:
    """Median host milliseconds (each ended by a synchronize) of the steps
    of one grid-1024 ``render`` call on the per-level route: packing the
    tables, ray generation, the stats kernel, phase A of one level (~20
    small PyTorch ops on the device), one level's kernel (level 0), the
    whole chain, and the tone map."""
    from raytracer_tpu_torch.core.v3 import V3
    from raytracer_tpu_torch.ops import cuda_fold, cuda_level
    from raytracer_tpu_torch.ops.tonemap import reinhard_tonemap
    from raytracer_tpu_torch.ops.trace import raygen_tile
    from raytracer_tpu_torch.models import scenes

    scene = scenes.grid_sphere_scene(1024, device=device)
    camera = scenes.reference_demo_camera(device=device)
    tables = cuda_fold.fused_tables(scene)
    o, d, w = frame_rays(width, height, device)
    stats = cuda_level.ray_stats(tables, o, d, w)
    sl = cuda_level.phase_a(stats, tables)
    rgb, _, _ = cuda_level.trace_levels(tables, o, d, w, depth)
    tt, ii = torch.empty_like(w), torch.empty(w.shape, dtype=torch.int32, device=device)
    nxt = [torch.empty_like(w) for _ in range(7)]
    acc = V3(*(torch.zeros_like(w) for _ in range(3)))
    steps = {
        "fused_tables": lambda: cuda_fold.fused_tables(scene),
        "raygen": lambda: [c.broadcast_to(d.x.shape) for c in raygen_tile(camera, width, height)],
        "ray_stats": lambda: cuda_level.ray_stats(tables, o, d, w),
        "phase_a": lambda: cuda_level.phase_a(stats, tables),
        "trace_level_0": lambda: cuda_level.trace_level(tables, sl, o, d, w, acc, tt, ii, nxt,
                                                        False, None, True),
        "trace_levels": lambda: cuda_level.trace_levels(tables, o, d, w, depth),
        "tonemap": lambda: reinhard_tonemap(rgb.stacked()),
    }
    return host_ms(steps, iters)


def profile_frame(device) -> dict:
    """``torch.profiler`` over one grid-1024 ``render`` at 1920x1080 d3 and
    one fit step (``level_fit_optimizer``, as ``drive_level_training``
    checks it): each kernel's summed device time (the profiler's
    device-side events only), and the share of the window's wall time (CUDA
    events, the profiler's own overhead included) that the device spent in
    none of them."""
    from raytracer_tpu_torch import make_fit_step, render
    from raytracer_tpu_torch.models import scenes

    scene = scenes.grid_sphere_scene(1024, device=device)
    camera = scenes.reference_demo_camera(device=device)
    start, _, target = level_fit_start(device)
    init_fn, step_fn = make_fit_step(1920, 1080, depth=3, device=device,
                                     optimizer=level_fit_optimizer)
    state = init_fn(start)
    work = {
        "render": lambda: render(scene, camera, 1920, 1080, depth=3, device=device),
        "fit_step": lambda: step_fn(state, start, camera, target),
    }
    out = {}
    for name, fn in work.items():
        fn()
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
        wall = e0.elapsed_time(e1)
        rows = []
        for ev in prof.key_averages():
            if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
                continue  # a host op: its kernels are counted as their own events
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(ev, "self_cuda_time_total", 0.0)
            if dev_us > 0:
                rows.append((ev.key, dev_us / 1e3, ev.count))
        rows.sort(key=lambda r: -r[1])
        busy = sum(r[1] for r in rows)
        out[name] = dict(wall_ms=wall, device_busy_ms=busy,
                         idle_share=max(0.0, 1.0 - busy / wall) if wall else None,
                         top=[(k[:60], round(ms, 4), c) for k, ms, c in rows[:8]])
    return out


def print_level(r: dict):
    print(
        f"per-level {r['name']}: ok={r['ok']} n_c={r['n_c']} shortlists={r['per_tile']} "
        + (f"stats_exact={r['stats_exact']} stats_sum_abs={r['stats_sum_abs']:.3g} "
           f"stats_sum_rel={r['stats_sum_rel']:.3g} "
           f"shortlists_same={r['shortlists_same']} " if r["per_tile"] else "")
        + f"levels_bad={r['levels_bad']} listed_chunks_per_level="
        f"{[round(v, 2) for v in r['listed']]} alive={r['alive']} "
        f"chain_mismatches={r['chain_mismatches']} chain_max_abs_err={r['chain_max_abs_err']:.3g} "
        f"dead_ok={r['dead_ok']} bwd: ok={r['bwd_ok']} "
        f"plane_exceptions={r['bwd_plane_exceptions']} plane_rel_max={r['bwd_plane_rel_max']:.3g} "
        f"leaf_rel_max={r['bwd_leaf_rel_max']:.3g} max|plain|: planes={r['bwd_plane_scale']:.3g} "
        f"leaves={r['bwd_leaf_scale']:.3g}", flush=True,
    )
    if "level_ms" in r:
        print(
            f"per-level {r['name']} times (ms per launch, CUDA events): "
            + (f"ray_stats {r['stats_ms']:.4f} (bound {r['stats_bound_ms']:.4f} "
               f"{r['stats_bound_by']}, plain {r['stats_plain_ms']:.2f}) " if r["per_tile"] else "")
            + f"trace_level {[round(v, 4) for v in r['level_ms']]} "
            f"(bound {[round(v, 4) for v in r['level_bound_ms']]} {r['level_bound_by']}, "
            f"plain {[round(v, 1) for v in r['level_plain_ms']]}) "
            f"trace_level_bwd {[round(v, 4) for v in r['bwd_ms']]} "
            f"(bound {[round(v, 4) for v in r['bwd_bound_ms']]} {r['bwd_bound_by']}, "
            f"plain {[round(v, 1) for v in r['bwd_plain_ms']]}) chain call {r['chain_ms']:.4f}",
            flush=True,
        )


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from raytracer_tpu_torch.ops import _build, cuda_level
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
    kernels_built = ["trace_whole", "trace_whole_bwd", "ray_stats", "trace_level",
                     "trace_level_bwd"]
    _build.build(kernels_built)
    print(f"build: {', '.join(kernels_built)} {time.perf_counter() - t0:.1f} s", flush=True)

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

    level_results = []
    for j, case in enumerate(LEVEL_CASES):
        r = check_levels(case, "cuda", timed=j < 2)
        level_results.append(r)
        ok &= r["ok"]
        print_level(r)
    lmain = level_results[0]

    sweep = tile_sweep("cuda")
    for row in sweep:
        print(f"tile sweep grid1024 1920x1080 d3 tile={row['tile']}: "
              f"kernels_ms={row['sum_ms']:.4f} ray_stats={row['stats_ms']:.4f} "
              f"trace_level={[round(v, 4) for v in row['level_ms']]} "
              f"listed_chunks={[round(v, 2) for v in row['listed']]}", flush=True)
    best = min(sweep, key=lambda row: row["sum_ms"])
    print(f"tile sweep: fastest {best['tile']}, default LEVEL_TILE {cuda_level.LEVEL_TILE}",
          flush=True)
    for row in whole_vs_levels("cuda"):
        ok &= row["mismatches"] <= 1e-5 * row["alive"]
        k = row["kernels"]
        print(f"whole vs per-level {row['name']} 1920x1080 d3 ({row['n_c']} chunks, table "
              f"{row['table_bytes']} B): forward trace_whole_ms={row['whole_ms']:.4f} "
              f"per_level_kernels_ms={k['sum_ms']:.4f} (ray_stats {k['stats_ms']:.4f}, "
              f"trace_level {[round(v, 4) for v in k['level_ms']]}, listed "
              f"{[round(v, 2) for v in k['listed']]}) call_ms whole={row['whole_call_ms']:.4f} "
              f"per_level={row['levels_call_ms']:.4f}; backward trace_whole_bwd_ms="
              f"{row['whole_bwd_ms']:.4f} per_level_call_ms={row['levels_bwd_call_ms']:.4f}; "
              f"selection_mismatches={row['mismatches']} of {row['alive']} alive "
              f"t_equal_where_same={row['t_equal']}", flush=True)

    # ---- small scenes: sprint3 render and fit (the whole-trace kernels) ----
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

    # ---- large scenes: grid-1024 render (1080p d3, c5 4K d4) and fit (per-level) ----
    grid = scenes.grid_sphere_scene(1024, device="cuda")
    img, level_launches = drive_level_path("cuda")
    lim = check_level_image(img, 1920, 1080, "cuda")
    level_ok = (level_launches == launches_of(ray_stats=1, trace_level=4)) and lim["ok"]
    ok &= level_ok
    lbench = benchmark_render(grid, camera, 1920, 1080, depth=3, iters=20)
    print(
        f"main path render grid1024 1920x1080 d3: launches={level_launches} ok={level_ok} "
        f"image={lim} frame_ms={lbench['frame_ms']:.4f} "
        f"rays_per_s={lbench['primary_rays_per_s']:.4g} "
        f"(all {[round(v, 4) for v in lbench['frame_ms_all']]})", flush=True,
    )
    img4k, c5_launches = drive_level_path("cuda", 3840, 2160, 4)
    c5_img = image_stats(img4k)
    c5_ok = (c5_launches == launches_of(ray_stats=4, trace_level=20)
             and c5_img["shape"] == (2160, 3840, 3) and c5_img["range_ok"]
             and c5_img["nonfinite"] <= 1e-5 * 3840 * 2160)
    ok &= c5_ok
    c5 = benchmark_render(grid, camera, 3840, 2160, depth=4, iters=5)
    print(
        f"main path render c5 grid1024 3840x2160 d4 (4 row chunks): launches={c5_launches} "
        f"ok={c5_ok} image={c5_img} frame_ms={c5['frame_ms']:.4f} "
        f"rays_per_s={c5['primary_rays_per_s']:.4g} "
        f"(all {[round(v, 4) for v in c5['frame_ms_all']]})", flush=True,
    )
    ltrain = drive_level_training("cuda")
    ok &= ltrain["ok"]
    lstart, _, _ = level_fit_start("cuda")
    lfit = benchmark_fit_step(lstart, camera, 1920, 1080, depth=3, iters=5,
                              optimizer=level_fit_optimizer)
    print(
        f"main path fit grid1024 1920x1080 d3, 5 make_fit_step steps: "
        f"launches={ltrain['launches']} per_step={ltrain['per_step'][0]} ok={ltrain['ok']} "
        f"losses={[float(f'{v:.6g}') for v in ltrain['losses']]} "
        f"max|grad center|={[float(f'{v:.3g}') for v in ltrain['grad_center_max']]} "
        f"max|grad color|={[float(f'{v:.3g}') for v in ltrain['grad_color_max']]} "
        f"step_ms={lfit['step_ms']:.4f} (all {[round(v, 4) for v in lfit['step_ms_all']]})",
        flush=True,
    )
    fb = benchmark_forward_backward(grid, camera, 1920, 1080, depth=3, iters=3, rounds=3)
    print(
        f"forward/backward grid1024 1920x1080 d3: forward_ms={fb['forward_ms']:.4f} "
        f"forward_train_ms={fb['forward_train_ms']:.4f} "
        f"forward_backward_ms={fb['forward_backward_ms']:.4f} "
        f"backward_ms={fb['backward_ms']:.4f} bwd_fwd_ratio={fb['bwd_fwd_ratio']:.4f} "
        f"ratio_rounds={[round(v, 4) for v in fb['bwd_fwd_ratio_rounds']]}", flush=True,
    )
    lbd = level_frame_breakdown("cuda")
    print("frame breakdown grid1024 1920x1080 d3 (host ms, synchronized): "
          + " ".join(f"{k}={v:.4f}" for k, v in lbd.items()), flush=True)
    try:
        prof = profile_frame("cuda")
        for name, p in prof.items():
            print(f"profile grid1024 1920x1080 d3 {name}: wall_ms={p['wall_ms']:.4f} "
                  f"device_busy_ms={p['device_busy_ms']:.4f} idle_share={p['idle_share']} "
                  f"top={p['top']}", flush=True)
    except Exception as exc:  # the profiler's CUDA trace is untried on this machine
        print(f"profile: not available ({type(exc).__name__}: {exc})", flush=True)

    guards = check_guards("cuda")
    ok &= all(guards.values())
    print(f"guards (per-level route on CUDA, gradient paths run, refused launch raises): "
          f"{guards}", flush=True)

    def frame_sum(values):
        return float(sum(values))

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
    }, {
        "name": "ray_stats", "route": "cuda",
        "source": "raytracer_tpu_torch/csrc/ray_stats.cu",
        "replaces": "raytracer_tpu/ops/pallas_fold.py:1582",
        "launches": level_launches["ray_stats"],
        "launches_by_path": {"render_grid1024": level_launches["ray_stats"],
                             "render_c5": c5_launches["ray_stats"],
                             "fit_5_steps": ltrain["launches"]["ray_stats"]},
        "max_abs_err": max(r.get("stats_sum_abs", 0.0) for r in level_results),
        "max_rel_err": max(r.get("stats_sum_rel", 0.0) for r in level_results),
        "ms": lmain["stats_ms"], "plain_ms": lmain["stats_plain_ms"],
        "bound_ms": lmain["stats_bound_ms"], "bound_by": lmain["stats_bound_by"],
        "library_ms": None,
        "check": all(r["ok"] for r in level_results),
    }, {
        "name": "trace_level", "route": "cuda",
        "source": "raytracer_tpu_torch/csrc/trace_level.cu",
        "replaces": "raytracer_tpu/ops/pallas_fold.py:1629",
        "launches": level_launches["trace_level"],
        "launches_by_path": {"render_grid1024": level_launches["trace_level"],
                             "render_c5": c5_launches["trace_level"],
                             "fit_5_steps": ltrain["launches"]["trace_level"]},
        "max_abs_err": max(r["chain_max_abs_err"] for r in level_results),
        "ms": frame_sum(lmain["level_ms"]), "ms_per_level": lmain["level_ms"],
        "plain_ms": frame_sum(lmain["level_plain_ms"]),
        "bound_ms": frame_sum(lmain["level_bound_ms"]), "bound_by": lmain["level_bound_by"],
        "library_ms": None,
        "check": all(r["ok"] for r in level_results),
    }, {
        "name": "trace_level_bwd", "route": "cuda",
        "source": "raytracer_tpu_torch/csrc/trace_level_bwd.cu",
        "replaces": "raytracer_tpu/ops/pallas_fold.py:2377",
        "launches": ltrain["launches"]["trace_level_bwd"],
        "launches_by_path": {"render_grid1024": level_launches["trace_level_bwd"],
                             "fit_5_steps": ltrain["launches"]["trace_level_bwd"]},
        "max_abs_err": lmain["bwd_max_abs_err"],
        "max_rel_err_all_cases": max(max(r["bwd_leaf_rel_max"], r["bwd_plane_rel_max"])
                                     for r in level_results),
        "ms": frame_sum(lmain["bwd_ms"]), "ms_per_level": lmain["bwd_ms"],
        "plain_ms": frame_sum(lmain["bwd_plain_ms"]),
        "bound_ms": frame_sum(lmain["bwd_bound_ms"]), "bound_by": lmain["bwd_bound_by"],
        "library_ms": None,
        "check": all(r["bwd_ok"] for r in level_results),
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
