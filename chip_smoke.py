#!/usr/bin/env python3
"""Build the port's CUDA kernels and drive its main paths on one GPU.

    python3 chip_smoke.py

Phases, one line each: the card's name and power limit; the build of the
nine kernels from csrc/ (one nvcc each, started together); the whole-trace
kernels against their plain PyTorch versions on their seven workloads (up to
grid-768 at 1920x1080 d3; the forward with and without its residual planes,
the backward on the forward's residuals); the per-level kernels (ray_stats, trace_level,
trace_level_bwd) against theirs on six workloads (grid-2048 at 1080p and
five lights among them), level by level on the same inputs and shortlists, then the chain end
to end and its backward, and the stats and a level on rays with zero, tiny
and non-finite direction components (the stats' warp cull); a
sweep of tile shapes and the whole-vs-per-level times (with, for each lane
whose selection differs between the routes, the ungated fold as arbiter); the small-scene
render path (``render`` of sprint3 at 1920x1080, depth 3) and its training
path (10 ``make_fit_step`` steps); the large-scene render path (``render``
of grid-1024 at 1920x1080, depth 3, and at 3840x2160, depth 4) and its
training path (5 steps at 1920x1080, depth 3); the soft kernels
(soft_level, soft_level_bwd) against their plain versions on nine
workloads (up to 8192 spheres), level by level, the residual planes and the
backward included, the backward bit for bit on a repeat; the soft launch plan against the kernels' own shared
memory; the soft diagnosis (``ptxas -v`` of every instantiation of both
soft kernels, their blocks per SM, and per level of c4, grid-1024 and
grid-2048 at 1920x1080 their times and bounds, the chunks a lane, a warp and
a block reach in launch order, the chunks the warp cull passes and the
share of dead lanes); the soft render path (``render_soft`` of BASELINE
c4, grid-64 at 1920x1080, depth 1) and its training path (20
``make_fit_step(soft=True)`` steps from moved centres, the loss and the
centre error falling); the app phase, through the command line
(``app.cli.main``): the c4 fit app in full (``fit --config
c4-fit-64sphere --steps 600``: the hard target, the annealed tau, the
cosine schedule; 2 soft_level and 2 soft_level_bwd launches a step, its
artefacts, its final loss, centre error and hard PSNR held to bars and
printed beside the JAX package's own run, its step times), the JAX
package's fitted c4 state (docs/fit_c4/checkpoint.npz) carried across,
rendered and resumed for 10 steps, ``render`` of c3 (the PNG against
``render`` pixel for pixel), ``render --depth-only`` of c1, ``render`` of
c5 on one card, ``--mesh 2,1`` refused, ``bench --fwd-bwd --trace`` of c3
(its trace naming both whole-trace kernels) and ``view`` of c2 for 3
frames; the distribution phase (parallel/): on a one-rank NCCL group c5
through ``render_sharded`` on the 1x1 mesh and through ``render --mesh
1,1`` (bit for bit with ``render``), sprint3 1920x1080 d3 on it, and three
c4 soft fit steps with the 1x1 mesh against three without (bit for bit);
then two gloo ranks on the one card (``parallel/dryrun.spawn``): grid-1024
1920x1080 d3 on a (2, 1) mesh (bit for bit with ``render``) and on a (1, 2)
mesh (each level's combined (t, index) and the image bit for bit with the
single-rank per-level loop, within 1e-4 of ``render``), and meshed fit
steps at (2, 1) (sprint3, grid-1024, c4 soft) against single-rank steps;
the closest-hit
kernels (fold_flat, fold_shortlist, fold_shortlist_hit) against their plain
versions on eight workloads (primary and level-1 bounce rays, an all-dead
mask; up to grid-2048) and against each other, their times and bounds (on
primary rays, and on each level of the grid-1024 loop), fold_flat bit for
bit with its plain version on the flat diagnosis's workloads (grid-1024
1920x1080's primary rays and each level of its loop, grid-4096 and
grid-8192 at 480x270 among them) and with its spheres streamed in tiles,
its launch plan against the kernel's layout, and the sweep of
``closest_hit_soa``'s record cut-off; the closest-hit paths: ``render_depth``
of BASELINE c1 (320x240), of grid-1024 at 1920x1080 and of c5 (3840x2160,
4 row chunks), the ``"pallas"`` selector's fold as a direct caller runs it
(c1, grid-1024), ``render(fold="pallas_flat")`` of sprint3 and of grid-1024
at 1920x1080 d3 (grid-1024's image against the default route's, differing
only on lanes where the ungated and gated folds differ), and
the per-level loop around ``closest_hit_soa`` on grid-1024 1920x1080 d3 with
its gradient; each path with the kernel launch counts set to 0 just before
it and read just after; the frame, fit step (soft: c4, grid-1024,
grid-2048, grid-4096) and forward/backward times; the span registry's
per-request medians of 20 c5 frames and 20 c4 soft fit steps recorded after
the timed calls (``span_medians``); the guards; a ``kernels`` JSON line. The last line is
``{"ok": true, "device": {...}}``. Any failed check ends the run with a
non-zero exit code and no result line, and names the failed checks on
standard error. Without CUDA, or without the package
beside it, it exits non-zero at once.

    python3 chip_smoke.py --soft-only [--root DIR]
    python3 chip_smoke.py --soft-compare PARENT_DIR [--out FILE]

``--soft-only`` runs the soft diagnosis and the soft fit steps of 64 to
4096 spheres on the package at DIR (default: beside this script), then
prints them as one JSON line. ``--soft-compare`` runs it on the package
unpacked at PARENT_DIR and on this one in turns (parent, change, change,
parent), each in its own process on the same card, and with ``--out``
writes the runs to FILE as JSON.

    python3 chip_smoke.py --level-only [--root DIR]
    python3 chip_smoke.py --level-compare PARENT_DIR [--out FILE]

``--level-only`` runs the per-level diagnosis on the package at DIR
(``ptxas -v`` and blocks per SM of ray_stats, trace_level and
trace_level_bwd; per level of grid-1024 1920x1080 d3, c5 3840x2160 d4 and
grid-2048 1920x1080 d3 the trace_level time with and without its stats
tail, the lanes alive, the listed chunks, the chunk reach of a lane and the
union of a warp, the fold's work by route and the stats cull where the
package has their plain mirrors, and the backward's time, winners a warp
and float64 atomics), the frames of grid-1024 and grid-2048 at 1080p d3 and
of c5, the grid-1024 fit step, and the times of the kernels that share
trace_common.cuh (trace_whole, trace_whole_bwd, the folds); then prints
them as one JSON line. ``--level-compare`` runs it as ``--soft-compare``
does.

    python3 chip_smoke.py --hit-only [--root DIR]
    python3 chip_smoke.py --hit-compare PARENT_DIR [--out FILE]

``--hit-only`` runs the closest-hit diagnosis on the package at DIR
(``ptxas -v`` and blocks per SM of fold_shortlist; on the depth pass's
primary rays of grid-1024, grid-64, sprint3 and grid-2048 at 1920x1080, c5
3840x2160 in its 4 row chunks and c1 320x240, and on each level of the
grid-1024 1920x1080 d3
loop around ``closest_hit_soa``, both variants' time a launch, the lanes
alive, the listed chunks, the chunk reach of a lane and the union of a
warp, and the fold's work by route from the plain mirror), the frames of
``render_depth`` (grid-1024 1080p, c5), the loop and the ``"pallas"`` fold
pass, and the times of the kernels that share trace_common.cuh
(trace_whole, trace_whole_bwd, ray_stats, trace_level, trace_level_bwd,
fold_flat; trace_level also on the demo scene at 640x640 d12); then
prints them as one JSON line, and exits non-zero if the fold kernel
differs from its plain mirror or the record kernel's index from the
fold's on any launch. ``--hit-compare`` runs it as ``--soft-compare``
does.

    python3 chip_smoke.py --whole-only [--root DIR]
    python3 chip_smoke.py --whole-compare PARENT_DIR [--out FILE]

``--whole-only`` runs the whole-trace diagnosis on the package at DIR
(``ptxas -v`` and blocks per SM of trace_whole and trace_whole_bwd; on
sprint3 1920x1080 d3, demo 640x640 d10 and grids of 64 to 768 spheres at
1920x1080 d3 the forward's time with and without its residual planes and
the backward's, with their bounds; per level of sprint3, grid-64 and
grid-768 the lanes alive, and under row strips, 16x16 and 32x8 tiles the alive
lanes a warp, the chunk reach of a lane and the union of a warp, and the
fold's work by route from the plain mirror ``whole_pair_reference``, and
the backward's winners a warp), the route rows (``whole_vs_levels``,
forward and backward, kernels and calls) and the times of the kernels that
share trace_common.cuh; then prints them as one JSON line, and exits
non-zero if the forward kernel differs from its plain mirror.
``--whole-compare`` runs it as ``--soft-compare`` does.

    python3 chip_smoke.py --flat-only [--root DIR]
    python3 chip_smoke.py --flat-compare PARENT_DIR [--out FILE]

``--flat-only`` runs the brute-force fold's diagnosis on the package at DIR
(``ptxas -v`` and blocks per SM of fold_flat; on the primary rays of c1
320x240, sprint3, grid-64, grid-1024 and grid-2048 at 1920x1080, the mixed
and walls-only scenes at 256x128, grid-130 at 333x111 and grid-4096 and
grid-8192 at 480x270, and on each level of the grid-1024 1920x1080 d3 loop,
the time a launch, its bound and share, and its issue-slot floor at the SM
clock measured under load; on grid-1024's primary rays and level 2 the
share of ray-sphere tests that reach the square root, from the plain
mirror), the ``render(fold="pallas_flat")`` and default frames of sprint3
and grid-1024 at 1920x1080 d3, and the times of the kernels that share
trace_common.cuh; then prints them as one JSON line, and exits non-zero if
the kernel differs from its plain version or mirror. ``--flat-compare`` runs
it as ``--soft-compare`` does. The five modes share one harness
(``COMPARE_MODES``, ``only``, ``compare``).

    python3 chip_smoke.py --dist-only

``--dist-only`` builds the kernels and runs the distribution phase alone,
and exits non-zero if any of its checks fails.

    python3 chip_smoke.py --bounce-only [--root DIR]

``--bounce-only`` checks the hard path's bounce, the upstream's reflect, on
the package at DIR (default: beside this script): the whole-trace kernels
(grid-64) and the per-level kernels (grid-1024) against their plain
versions, backwards included, and the per-level loop around the
shortlist-hit kernel against the chain, all at 1920x1080 d4 on frames whose
first rows graze the spheres, with every level's direction unit to 1e-6;
c5's frame (grid-1024, 3840x2160 d4) finite at the pixels that overflowed
under the old bounce; ``make_fit_step(3840, 2160, depth=4)`` from three
seeds' start draws with finite losses and gradients and its memory peak;
then the changed kernels' times (c5's levels, grid-768 and sprint3) and
their ``ptxas -v`` registers and spills, and one JSON line of them all. It
exits non-zero if a check fails.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import io
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and float32 (non-tensor)
# FLOP/s.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12

# (name, scene factory name and args, width, height, depth). The first is
# the main path's shape; the fifth has a ragged end (n % 256 != 0); the
# sixth is a 16-chunk scene of the widened fused class, the last its largest
# scene (24 chunks, a 45 KB table) at full size. The 1080p grids run in
# tiles whose last row overhangs the frame. These are the whole-trace
# kernels' workloads.
CASES = (
    ("sprint3_1920x1080_d3", ("sprint3_scene", ()), 1920, 1080, 3),
    ("demo_640x640_d10", ("reference_demo_scene", ()), 640, 640, 10),
    ("grid64_1920x1080_d3", ("grid_sphere_scene", (64,)), 1920, 1080, 3),
    ("mixed_256x128_d2", ("mixed_primitive_scene", ()), 256, 128, 2),
    ("sprint3_333x111_d3", ("sprint3_scene", ()), 333, 111, 3),
    ("grid512_640x360_d3", ("grid_sphere_scene", (512,)), 640, 360, 3),
    ("grid768_1920x1080_d3", ("grid_sphere_scene", (768,)), 1920, 1080, 3),
)

# The per-level chain's workloads. The first is the main path's shape:
# grid-1024, the scene of BASELINE config c5 and bench.py's large frame, at
# 1920x1080 d3. Then ragged tiles on a 9-chunk scene, boxes and 5 chunks,
# identity lists (one chunk) at a depth past the whole-trace class,
# grid-2048 (64 chunks, a 44 KB table) at 1920x1080 d3, and five lights
# (trace_level_bwd sums their cotangents per warp past three).
LEVEL_CASES = (
    ("grid1024_1920x1080_d3", ("grid_sphere_scene", (1024,)), 1920, 1080, 3),
    ("grid130_333x111_d3", ("grid_sphere_scene", (130,)), 333, 111, 3),
    ("grid80boxes_256x128_d2", ("grid80_boxes", ()), 256, 128, 2),
    ("demo_640x640_d12", ("reference_demo_scene", ()), 640, 640, 12),
    ("grid2048_1920x1080_d3", ("grid_sphere_scene", (2048,)), 1920, 1080, 3),
    ("grid130lights_256x128_d2", ("grid130_lights", ()), 256, 128, 2),
)
# Tile shapes (rows, cols) of the per-level kernels' sweep: one block each.
TILES = ((8, 32), (16, 16), (4, 64), (2, 128))

# The soft kernels' workloads, each at depth 1 (two levels), tau 0.01 and
# tau_z 0.05 (make_fit_step's defaults). The first is the main path's shape:
# BASELINE config c4 (app/config.py: grid-64 at 1920x1080, depth 1, a fit).
# Then walls and a sun (sprint3), boxes (the mixed scene), the single-chunk
# sphere gate (grid-4), a ragged frame (333x111), and the two large soft fits'
# scenes (bench.py: grid-1024 and grid-2048) at a quarter of 1080p each way:
# the plain versions run every chunk for every lane and are slow there. Then
# grid-4096 (a 16-tile ring) and grid-8192 (past the JAX kernel's 4096
# spheres) at an eighth of 1080p each way, for the same reason.
SOFT_CASES = (
    ("c4_grid64_1920x1080_d1", ("grid_sphere_scene", (64,)), 1920, 1080),
    ("sprint3_1920x1080_d1", ("sprint3_scene", ()), 1920, 1080),
    ("mixed_256x128_d1", ("mixed_primitive_scene", ()), 256, 128),
    ("grid4_640x360_d1", ("grid_sphere_scene", (4,)), 640, 360),
    ("grid64_333x111_d1", ("grid_sphere_scene", (64,)), 333, 111),
    ("grid1024_480x270_d1", ("grid_sphere_scene", (1024,)), 480, 270),
    ("grid2048_480x270_d1", ("grid_sphere_scene", (2048,)), 480, 270),
    ("grid4096_240x135_d1", ("grid_sphere_scene", (4096,)), 240, 135),
    ("grid8192_240x135_d1", ("grid_sphere_scene", (8192,)), 240, 135),
)
SOFT_TAU, SOFT_TAU_Z = 0.01, 0.05

# The closest-hit kernels' workloads (fold_flat, fold_shortlist,
# fold_shortlist_hit), each on the frame's primary rays and on its level-1
# bounce rays with their alive mask. The first is BASELINE c1 (the demo
# scene at 320x240, a depth pass: app/config.py:80-84); then the frame of
# the fold="pallas_flat" render path (sprint3 1080p), grid-64 at 1080p,
# boxes (the mixed scene), ragged tiles with shortlists (grid-130 at
# 333x111), a walls-only scene (sprint3 without its sphere), grid-1024
# (c5's scene) and grid-2048 (64 chunks of 32 spheres, a 36 KB shared
# table) at a quarter of 1080p each way: the plain versions fold every
# listed chunk of every lane at once and are slow there.
HIT_CASES = (
    ("c1_demo_320x240", ("reference_demo_scene", ()), 320, 240),
    ("sprint3_1920x1080", ("sprint3_scene", ()), 1920, 1080),
    ("grid64_1920x1080", ("grid_sphere_scene", (64,)), 1920, 1080),
    ("mixed_256x128", ("mixed_primitive_scene", ()), 256, 128),
    ("grid130_333x111", ("grid_sphere_scene", (130,)), 333, 111),
    ("walls_only_256x128", ("walls_only", ()), 256, 128),
    ("grid1024_480x270", ("grid_sphere_scene", (1024,)), 480, 270),
    ("grid2048_480x270", ("grid_sphere_scene", (2048,)), 480, 270),
)
# Where the closest-hit kernels are timed: the frames of their main paths
# (c1's depth pass, render(fold="pallas_flat") of sprint3, render_depth and
# the per-level loop of grid-1024, each level) and grid-64. There each
# kernel's output is also held bit for bit against its plain version's.
HIT_TIME_CASES = (
    ("c1_demo_320x240", ("reference_demo_scene", ()), 320, 240),
    ("sprint3_1920x1080", ("sprint3_scene", ()), 1920, 1080),
    ("grid64_1920x1080", ("grid_sphere_scene", (64,)), 1920, 1080),
    ("grid1024_1920x1080", ("grid_sphere_scene", (1024,)), 1920, 1080),
)
# Tolerance of the soft backward kernel against its plain version: each
# cotangent plane within 1e-4 of its largest entry, each table array within
# 1e-3 of its largest entry. The kernel takes the same derivatives by hand,
# rounded in another order than autograd's (a lane's terms differ in their
# last bits), and its warp and block sums run in another order; a table
# entry sums such terms of both signs over every lane (0.5 M at 1080p), and
# where they cancel, the float32 rounding of the terms shows at ~1e-4 of
# the array's largest entry (grid-1024 at 480x270: 1.14e-4 on the H100, PERF.md).
SOFT_BWD_TOL, SOFT_TABLE_TOL = 1e-4, 1e-3


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


def whole_bound(tables, idx: torch.Tensor, alive: torch.Tensor, depth: int) -> dict:
    """The whole-trace forward's bound on this run's data (selections
    ``idx`` and ``alive`` lanes per level): each of the 7 input planes read
    once, the rgb and each level's t and index written once (``bytes``),
    against ``trace_whole_ops`` (``ops``); with ``emit_res`` also the 7
    residual planes of each level past the first (``bound_res_ms``)."""
    n = idx[0].numel()
    out = dict(bytes=(7 + 3 + 2 * (depth + 1)) * n * 4,
               ops=trace_whole_ops(tables.counts, idx.cpu().numpy(), alive.cpu().numpy()))
    t_bytes, t_ops = out["bytes"] / PEAK_BYTES_S, out["ops"] / PEAK_F32_S
    out["bound_ms"] = max(t_bytes, t_ops) * 1e3
    out["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    t_res = (out["bytes"] + 7 * depth * n * 4) / PEAK_BYTES_S
    out["bound_res_ms"] = max(t_res, t_ops) * 1e3
    return out


def whole_bwd_bound(tables, levels, depth: int) -> dict:
    """The whole-trace backward's bound on this run's data: the image
    cotangent and the 7 output planes for every lane; each level's
    throughput for every lane, and its 6 ray planes, t and index only
    where the lane is alive (``bytes``), against ``trace_whole_bwd_ops``."""
    n = levels.w.numel()
    alive = [levels.level(k)[2] > 0 for k in range(depth + 1)]
    out = dict(bytes=4 * sum(n + 8 * int(a.sum()) for a in alive) + (3 + 7) * n * 4,
               ops=sum(trace_whole_bwd_ops(tables.counts, levels.i[k].cpu().numpy(),
                                           alive[k].cpu().numpy())
                       for k in range(depth + 1)))
    t_bytes, t_ops = out["bytes"] / PEAK_BYTES_S, out["ops"] / PEAK_F32_S
    out["bound_ms"] = max(t_bytes, t_ops) * 1e3
    out["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return out


def check_trace_whole(case, device, scale: int = 1, rays=None) -> dict:
    """The kernel against its plain version on one workload: selections,
    t and rgb, then both timed with CUDA events. ``rays`` (``(o, d, w)``
    planes of the case's frame) stand in for the demo camera's."""
    from raytracer_tpu_torch.models import scenes
    from raytracer_tpu_torch.ops import cuda_fold
    from raytracer_tpu_torch.ops.trace import MISS_T
    from raytracer_tpu_torch.utils.profiler import cuda_time_ms

    name, (factory, args), width, height, depth = case
    width, height = max(width // scale, 1), max(height // scale, 1)
    scene = getattr(scenes, factory)(*args, device=device)
    o, d, w = frame_rays(width, height, device) if rays is None else rays
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
    pairs = list(zip(rgb_k, rgb_p))
    # The plain version's own arithmetic overflows on a few firefly lanes (a
    # grazing bounce leaves a direction far from unit length and the
    # specular power reaches inf: one pixel of grid-768 at 1080p d3). There
    # the kernel must give the same value (inf where inf, NaN where NaN);
    # everywhere else it must be finite and close.
    both = torch.stack([torch.isfinite(a) & torch.isfinite(b) for a, b in pairs])[:, clean]
    err = torch.stack([(a - b).abs() for a, b in pairs])[:, clean][both]
    close = torch.stack([
        torch.isclose(a, b, rtol=1e-4, atol=1e-5) | same_mask(a, b) for a, b in pairs
    ])[:, clean]
    out = dict(
        name=name, shape=(height, width), depth=depth, alive=n_alive,
        mismatches=int(mism.sum()), mismatch_lines=lines, t_rel_max=t_rel_max,
        dead_ok=dead_ok, max_abs_err=float(err.max()) if err.numel() else 0.0,
        rgb_ok=bool(close.all()),
        finite=all(bool((torch.isfinite(a) | ~torch.isfinite(b)).all()) for a, b in pairs),
        nonfinite=sum(int((~torch.isfinite(a)).sum()) for a in rgb_k),
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
    out.update(whole_bound(tables, i_p, alive, depth))
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
    # Where the forward overflowed (a firefly lane, check_trace_whole), the
    # plain version's cotangents are not finite; the kernel's must be not
    # finite there too, and finite and close everywhere else (scales and
    # errors over the finite entries).
    def finite_abs(x):
        return x.abs()[torch.isfinite(x)]

    n_bad = 0
    out["nonfinite"] = 0
    for pn, a, b in zip(planes, k_planes, p_planes):
        fin = torch.isfinite(b)
        scale = float(finite_abs(b).max()) if bool(fin.any()) else 0.0
        bad = alive & ~torch.where(fin, torch.isclose(a, b, rtol=1e-3, atol=1e-5 * scale),
                                   ~torch.isfinite(a))
        n_bad += int(bad.sum())
        both = fin & torch.isfinite(a)
        out["plane_err"][pn] = float((a - b)[both].abs().max()) if bool(both.any()) else 0.0
        out["plane_rel_err"][pn] = out["plane_err"][pn] / scale if scale else out["plane_err"][pn]
        out["finite"] &= bool((torch.isfinite(a) | ~fin).all())
        out["nonfinite"] += int((~fin).sum())
        out["exceptions"] += [
            f"  {pn} pixel ({y},{x}): kernel {float(a[y, x])!r} plain {float(b[y, x])!r}"
            for y, x in bad.nonzero().tolist()[:50]
        ]
    out["plane_exceptions"] = n_bad
    kl = scene_leaf_grads(fwd["scene"], kern[3], kern[4])
    pl = scene_leaf_grads(fwd["scene"], plain[3], plain[4])
    leaf_rel, leaf_err = {}, {}
    out["leaf_nonfinite_same"] = set(kl) == set(pl)
    for j, b in pl.items():
        a = kl.get(j, torch.zeros_like(b))
        fin = torch.isfinite(b)
        out["leaf_nonfinite_same"] &= torch.equal(torch.isfinite(a), fin)
        scale = float(finite_abs(b).max()) if bool(fin.any()) else 0.0
        both = fin & torch.isfinite(a)
        leaf_err[j] = float((a - b)[both].abs().max()) if bool(both.any()) else 0.0
        leaf_rel[j] = leaf_err[j] / scale if scale else (0.0 if leaf_err[j] == 0.0 else float("inf"))
    out["leaf_rel_max"] = max(leaf_rel.values())
    out["leaf_scale"] = max(float(finite_abs(b).max()) if finite_abs(b).numel() else 0.0
                            for b in pl.values())
    out["plane_scale"] = max(float(finite_abs(b).max()) if finite_abs(b).numel() else 0.0
                             for b in p_planes)
    out["leaf_err_max"] = max(leaf_err.values())
    out["max_abs_err"] = max(out["leaf_err_max"], *out["plane_err"].values())
    out["max_rel_err"] = max(out["leaf_rel_max"], *out["plane_rel_err"].values())
    out["ok"] = (n_bad <= 1e-4 * n_alive and out["leaf_rel_max"] <= 1e-3 and out["finite"]
                 and set(kl) == set(pl) and out["leaf_nonfinite_same"])
    out.update(whole_bwd_bound(tables, levels, depth))
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
    """A workload's scene: a factory of models/scenes.py, grid-80 with the
    mixed scene's two boxes, grid-130 with four point lights and the sun,
    or sprint3 without its sphere."""
    from raytracer_tpu_torch.core import types
    from raytracer_tpu_torch.models import scenes

    factory, args = spec
    if factory == "grid80_boxes":
        grid = scenes.grid_sphere_scene(80, device=device)
        return grid.replace(boxes=scenes.mixed_primitive_scene(device=device).boxes)
    if factory == "grid130_lights":
        grid = scenes.grid_sphere_scene(130, device="cpu")
        lights = types.Lights.create(
            point_position=[(0.0, 0.0, 0.0), (2.0, 3.0, 4.0), (-3.0, 1.0, 2.0), (1.0, -4.0, 6.0)],
            point_color=[(1.0, 1.0, 1.0), (0.5, 0.4, 0.3), (0.2, 0.6, 0.2), (0.3, 0.3, 0.9)],
            sun_direction=scenes.SUN_DIRECTION, sun_color=scenes.SUN_COLOR)
        return grid.replace(lights=lights).to(device)
    if factory == "walls_only":
        scene = scenes.sprint3_scene(device=device)
        sp, mat = scene.spheres, scene.spheres.material
        return scene.replace(spheres=sp.replace(
            center=sp.center[:0], radius=sp.radius[:0],
            material=mat.replace(**{f.name: getattr(mat, f.name)[:0]
                                    for f in dataclasses.fields(mat)})))
    return getattr(scenes, factory)(*args, device=device)


def frame_rays(width: int, height: int, device):
    """The demo camera's primary rays as seven contiguous planes."""
    from raytracer_tpu_torch.models import scenes
    from raytracer_tpu_torch.ops.trace import raygen_tile

    o, d = raygen_tile(scenes.reference_demo_camera(device=device), width, height)
    o, d = o.broadcast_to(d.x.shape), d.broadcast_to(d.x.shape)
    return o, d, torch.ones(d.x.shape, dtype=torch.float32, device=device)


def ray_stats_ops(n_c: int, alive: np.ndarray, used: np.ndarray, cull=None) -> float:
    """Float32 operations of the stats of these lanes, reckoned from
    trace_common.cuh's `tile_stats` as ``trace_whole_ops`` is: the safe
    reciprocals and the slab clip for an alive lane (34), the segment ends,
    box and sums for a used lane (22) and the chunk gate for each chunk
    (25), and the reduction: one combine per value and lane (10 per
    lane). With ``cull`` (``stats_cull``: per lane the chunks its warp's
    cull passes, and the warps it judged), a used lane gates only those,
    and each judged warp tests every chunk's box once (20 each)."""
    gates = 25.0 * n_c * used.sum()
    if cull is not None:
        passes, warps = cull
        gates = 25.0 * passes[used].sum() + 20.0 * n_c * warps
    return float(34 * alive.sum() + 22 * used.sum() + gates + 10 * alive.size)


def stats_cull(tables, o, d, w):
    """``(passes, warps)`` for ``ray_stats_ops``: per lane the chunks its
    warp's stats cull passes (``cuda_level.warp_cull_reference``), and the
    warps with a used lane; None for a package without the cull."""
    from raytracer_tpu_torch.ops import cuda_level

    ref = getattr(cuda_level, "warp_cull_reference", None)
    if ref is None:
        return None
    _, cull = ref(tables, o, d, w)
    warp = cuda_level.lane_slots(w.shape, None, w.device)[2]
    return cull.sum(dim=1)[warp].cpu().numpy(), int(cull.any(dim=1).sum())


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
    the next level's stats (``ray_stats_ops`` of ``next_used``: alive,
    used and the cull) where the level writes them.
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
        ops += ray_stats_ops(c["n_c"], *next_used)
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


def check_levels(case, device, timed: bool = False, tile=None, rays=None) -> dict:
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
    run's data. ``rays`` (``(o, d, w)`` planes of the case's frame) stand
    in for the demo camera's."""
    from raytracer_tpu_torch.core.v3 import V3
    from raytracer_tpu_torch.ops import cuda_fold, cuda_level
    from raytracer_tpu_torch.ops.trace import MISS_T

    name, spec, width, height, depth = case
    scene = make_scene(spec, device)
    o, d, w = frame_rays(width, height, device) if rays is None else rays
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
        b_ops = ray_stats_ops(n_c, (w > 0).cpu().numpy(), used0.cpu().numpy(),
                              stats_cull(tables, o, d, w) if tile is None else None)
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
            no, nd, nw = V3(*res_k[k, :3]), V3(*res_k[k, 3:6]), res_k[k, 6]
            nu = ((nw > 0).cpu().numpy(), used_lanes(tables, no, nd, nw).cpu().numpy(),
                  stats_cull(tables, no, nd, nw) if tile is None else None)
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


def edge_rays(device, width: int = 96, height: int = 64):
    """grid-1024's camera rays at ``width`` x ``height`` with a lane in
    eleven given a direction that the stats' warp cull must not judge:
    zero, one or two zero components, components of 1e-13, a NaN or an
    infinite component (trace_common.cuh's ``cull_meets``)."""
    from raytracer_tpu_torch.core.v3 import V3

    o, d, w = frame_rays(width, height, device)
    dx, dy, dz = (c.clone() for c in d)
    n = dx.numel()
    kinds = ((0.0, 0.0, 0.0), (0.0, 0.0, None), (0.0, None, None), (None, 0.0, 0.0),
             (1e-13, -1e-13, 1e-13), (float("nan"), None, None), (None, float("inf"), None),
             (None, None, float("-inf")), (1e-13, None, 0.0), (-0.0, -0.0, 1.0))
    idx = torch.arange(n, device=device)
    for j, kind in enumerate(kinds):
        lanes = idx[(idx * 7919) % 11 == 0][j::len(kinds)]
        for comp, v in zip((dx, dy, dz), kind):
            if v is not None:
                comp.view(-1)[lanes] = v
    return o, V3(dx, dy, dz), w


def check_cull_edges(device) -> dict:
    """The stats kernel and one level of trace_level against their plain
    versions on ``edge_rays``: the stats' counts, flags and reach bits, and
    the level's selections, t (NaN where the plain t is) and next stats'
    reach bits, bit for bit."""
    from raytracer_tpu_torch.core.v3 import V3
    from raytracer_tpu_torch.ops import cuda_fold, cuda_level

    tables = cuda_fold.fused_tables(make_scene(("grid_sphere_scene", (1024,)), device))
    o, d, w = edge_rays(device)
    ks = cuda_level.ray_stats(tables, o, d, w)
    ps = cuda_level.ray_stats_reference(tables, o, d, w)
    sl = cuda_level.phase_a(ps, tables)
    acc = V3(*(torch.zeros_like(w) for _ in range(3)))
    pt, pi, _, _, _, _, pst = cuda_level.trace_level_reference(tables, sl, o, d, w, acc, False,
                                                               None, True)
    tt, ii = torch.empty_like(w), torch.empty(w.shape, dtype=torch.int32, device=device)
    nxt = [torch.empty_like(w) for _ in range(7)]
    kst = cuda_level.trace_level(tables, sl, o, d, w, V3(*(a.clone() for a in acc)), tt, ii,
                                 nxt, False, None, True)
    def same(a, b):  # equal, or NaN in both
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())

    # The used-lane count, the alive flag and the reach bits: the boxes of
    # tiles with a non-finite segment end differ (fminf drops a NaN that
    # torch.minimum keeps), as they did before the cull.
    out = dict(stats=torch.equal(ks[:, 9:], ps[:, 9:]), level_i=torch.equal(ii, pi),
               level_t=same(tt, pt), level_stats=torch.equal(kst[:, 9:], pst[:, 9:]))
    out["ok"] = all(out.values())
    return out


def event_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device milliseconds of one call of ``fn`` (CUDA events)."""
    from raytracer_tpu_torch.utils.profiler import cuda_time_ms

    return statistics.median(cuda_time_ms(fn, iters=iters, warmup=warmup))


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


# The route rows' grids: 4 to 24 chunks, the whole-trace class (grid-768's
# 45 KB table is the largest under its 48 KB); past it, grid-1024 (c5's
# scene, 32 chunks) and grid-2048 (64), whose tables the whole-trace kernels
# take too (their shared tables fit the 227 KB a block can have).
ROUTE_GRIDS = (64, 130, 256, 512, 768)
ROUTE_GRIDS_PAST = (1024, 2048)


def whole_vs_levels(device, grids=ROUTE_GRIDS) -> list:
    """Grids of ``grids`` spheres at 1920x1080 d3 through both
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
    for n in grids:
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
            arbitration=arbitrate(tables, lv_w, lv_l, alive),
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
            levels_bwd_kernels_ms=level_bwd_kernels_ms(tables, attrs, ls, lv_l, ct, 3),
            whole_bwd_call_ms=_calls_ms(
                lambda: cuda_fold.trace_whole_bwd(tables, attrs, ls, lv_w, ct, 3), 10),
            levels_bwd_call_ms=_calls_ms(
                lambda: cuda_level.trace_levels_bwd(tables, attrs, ls, lv_l, ct, 3), 10),
        ))
    return rows


def arbitrate(tables, lv_w, lv_l, alive, limit: int = 8) -> list:
    """The lanes where the whole-trace route's selection differs from the
    per-level chain's (at most ``limit``), each with the ungated fold as
    arbiter: its level and pixel, both selections, | |d| - 1 | of its
    direction on each route's rays of that level, whether those rays are
    the same, ``fold_flat``'s selection on each route's rays, and which
    route agrees with it."""
    from raytracer_tpu_torch.core.v3 import V3
    from raytracer_tpu_torch.ops import cuda_hit

    lanes = torch.nonzero(alive & (lv_w.i != lv_l.i))[:limit].tolist()
    flat = {}
    for k in sorted({lane[0] for lane in lanes}):
        for route, lv in (("whole", lv_w), ("levels", lv_l)):
            o, d, _ = lv.level(k)
            flat[route, k] = cuda_hit.fold_flat(tables, V3(*(c.contiguous() for c in o)),
                                                V3(*(c.contiguous() for c in d)))[1]
    rows = []
    for k, y, x in lanes:
        row = dict(level=k, pixel=(y, x))
        rays = {}
        for route, lv in (("whole", lv_w), ("levels", lv_l)):
            o, d, _ = lv.level(k)
            rays[route] = [float(c[y, x]) for c in (*o, *d)]
            row[route] = int(lv.i[k, y, x])
            row[f"norm_err_{route}"] = abs(float(np.linalg.norm(np.float64(rays[route][3:]))) - 1)
            row[f"flat_on_{route}_rays"] = int(flat[route, k][y, x])
        row["same_rays"] = rays["whole"] == rays["levels"]
        agree = [r for r in ("whole", "levels") if row[r] == row[f"flat_on_{r}_rays"]]
        row["agrees_with_flat"] = " and ".join(agree) or "neither"
        rows.append(row)
    return rows


def level_bwd_kernels_ms(tables, attrs, ls, levels, ct, depth: int) -> float:
    """The per-level backward chain's ``trace_level_bwd`` launches of one
    fit step, each timed alone on the cotangents the chain passes it
    (``event_ms``), summed."""
    from raytracer_tpu_torch.ops import cuda_level

    w = levels.w
    sums = (torch.zeros(attrs.shape, dtype=torch.float64, device=w.device),
            torch.zeros(ls.shape, dtype=torch.float64, device=w.device))
    total, ct_next = 0.0, None
    for k in reversed(range(depth + 1)):
        lo, ld, lw = levels.level(k)
        cn = ct_next

        def launch():
            return cuda_level.trace_level_bwd(tables, attrs, ls, lo, ld, lw, levels.t[k],
                                              levels.i[k], ct, cn, k == depth, sums)

        total += event_ms(launch, iters=10, warmup=2)
        ct_next = launch()
    return total


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
    from raytracer_tpu_torch.utils import profiler

    if hasattr(profiler, "reset_launches"):  # else a package from before the span registry
        profiler.reset_launches()


def read_launches() -> dict | None:
    """Each kernel's launches since ``reset_launches`` (the span registry's
    counts); None for a package from before the registry (``--MODE-compare``'s
    parent)."""
    from raytracer_tpu_torch.utils import profiler

    return profiler.launches() if hasattr(profiler, "launches") else None


def launches_of(**counts) -> dict:
    """Every kernel's count: the given ones, 0 for the others."""
    from raytracer_tpu_torch.utils.profiler import KERNELS

    return {name: counts.get(name, 0) for name in KERNELS}


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


# ---------------------------------------------------------------------------
# The soft renderer: soft_level and soft_level_bwd (kernels 6-7)
# ---------------------------------------------------------------------------


def soft_level_ops(counts: dict, reached: int, n: int, is_last: bool) -> float:
    """Float32 operations of one ``soft_level`` launch on this run's data,
    reckoned from csrc/soft_common.cuh (each add, mul, div, sqrt, rsqrt, exp,
    log, log1p, min, max and compare counts one): per lane every chunk's
    gate in both passes, every wall and box (its hit twice, its shading and
    its contribution) and the tail (~88); per reached (lane, chunk) pair the
    8 spheres' hit for t_ref (58) and again with the shading (6 + 66 per
    point light + 53 per sun) and the contribution (37; 17 at the last
    level)."""
    shade = 6 + 66 * counts["n_pt"] + 53 * counts["n_sun"]
    contrib = 17 if is_last else 37
    gate = 26 if counts["gate"] == 0 else 24
    wall = 71 + 68 + shade + contrib
    box = 70 + 67 + shade + contrib
    per_lane = 2 * gate * counts["n_chunks"] + counts["n_w"] * wall + counts["n_b"] * box + 88
    return float(per_lane) * n + 8.0 * (58 + 55 + shade + contrib) * reached


def soft_level_bwd_ops(counts: dict, reached: int, n: int, is_last: bool) -> float:
    """Float32 operations of one ``soft_level_bwd`` launch, reckoned as
    ``soft_level_ops`` is: per lane the gates once, the tail and its adjoint
    (~170), every wall and box's contribution again and its adjoint; per
    reached (lane, chunk) pair 8 spheres, each its hit (55), its shading
    twice (the colour, then the light sums again in the adjoint), the
    lights' adjoint (9 + 130 per point light + 100 per sun), the
    contribution's adjoint (60; 30 at the last level) and the hit's (65),
    and the 12 warp-summed cotangents."""
    n_pt, n_sun = counts["n_pt"], counts["n_sun"]
    shade = 6 + 66 * n_pt + 53 * n_sun
    adj = 9 + 130 * n_pt + 100 * n_sun
    cb = 30 if is_last else 60
    gate = 26 if counts["gate"] == 0 else 24
    wall = 68 + 2 * shade + adj + cb + 80 + 23
    box = 67 + 2 * shade + adj + cb + 75 + 14
    per_lane = gate * counts["n_chunks"] + 170 + counts["n_w"] * wall + counts["n_b"] * box
    return float(per_lane) * n + 8.0 * (55 + 2 * shade + adj + cb + 65 + 12) * reached


def soft_reached(tables, gates, o, d) -> int:
    """(lane, chunk) pairs whose gate passes: the chunks the kernels run."""
    from raytracer_tpu_torch.ops import cuda_soft

    c = tables.counts
    return sum(int(cuda_soft.chunk_reachable(gates, c["gate"], k, o, d, SOFT_TAU).sum())
               for k in range(c["n_chunks"]))


def soft_bound(ops: float, planes: int, n: int):
    """(bound ms, bound_by) of a launch: its operations at the float32 peak
    against its planes read and written once at the memory rate."""
    t_ops, t_bytes = ops / PEAK_F32_S * 1e3, 4.0 * planes * n / PEAK_BYTES_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _planes_of(out) -> list:
    return [p for x in out if x is not None for p in (x if isinstance(x, tuple) else (x,))]


def check_soft(case, device) -> dict:
    """``soft_level`` (gated) against ``soft_level_reference`` (every chunk
    for every lane) level by level on the same inputs, the residual planes
    included, then ``soft_level_bwd`` against ``soft_level_bwd_reference``
    level by level from a seeded image cotangent, each given the plain
    version's cotangents of its outputs; each kernel and plain version
    timed on its level's inputs (CUDA events). Every level is also launched
    in ``soft_lane_order`` (the order the fits' bounce levels of large
    scenes run in: each lane reads and writes the ray of the order plane),
    forward and backward: the forward must equal the plain version on the
    natural order bit for bit, the backward (from the same residual planes)
    must be within the tolerances, its table cotangent against the plain
    version's for that level alone. Each level's backward in lane order is
    launched twice more into fresh tables: both equal bit for bit (the
    kernel's sums do not depend on the order in which warps add)."""
    from raytracer_tpu_torch.core.v3 import V3
    from raytracer_tpu_torch.ops import cuda_soft

    name, spec, width, height = case
    scene = make_scene(spec, device)
    o, d, w = frame_rays(width, height, device)
    n = w.numel()
    with torch.no_grad():
        tables = cuda_soft.soft_tables(scene, SOFT_TAU, SOFT_TAU_Z)
    gates = cuda_soft.soft_gate_tables(scene, SOFT_TAU)
    counts = tables.counts
    acc = V3(*(torch.zeros_like(w) for _ in range(3)))
    r = dict(name=name, n_s=counts["n_s"], fwd_err=[], fwd_rel=[], fwd_identical=[],
             ms=[], ms_res=[], plain_ms=[], bound_ms=[], bound_by=[], reached=[],
             bwd_rel=[], bwd_ms=[], bwd_plain_ms=[], bwd_bound_ms=[], bwd_bound_by=[],
             order_identical=[], order_bwd_rel=[], order_table_rel=[], repeat_identical=[])
    levels = []
    with torch.no_grad():
        for k in range(2):
            last = k == 1
            got = _planes_of(cuda_soft.soft_level(tables, gates, o, d, w, acc, last, True))
            lean = _planes_of(cuda_soft.soft_level(tables, gates, o, d, w, acc, last, False))
            want_out = cuda_soft.soft_level_reference(tables, o, d, w, acc, last, True)
            want = _planes_of(want_out)
            err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            rel = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                      for a, b in zip(got, want))
            r["fwd_err"].append(err)
            r["fwd_rel"].append(rel)
            r["fwd_identical"].append(all(torch.equal(a, b) for a, b in zip(got, want))
                                      and all(torch.equal(a, b) for a, b in zip(lean, got)))
            order = cuda_soft.soft_lane_order(o, d)
            got_o = _planes_of(cuda_soft.soft_level(tables, gates, o, d, w, acc, last, True,
                                                    order=order))
            r["order_identical"].append(all(torch.equal(a, b) for a, b in zip(got_o, want)))
            r["ms"].append(event_ms(lambda: cuda_soft.soft_level(tables, gates, o, d, w, acc,
                                                                 last, False)))
            r["ms_res"].append(event_ms(lambda: cuda_soft.soft_level(tables, gates, o, d, w, acc,
                                                                     last, True)))
            r["plain_ms"].append(event_ms(lambda: cuda_soft.soft_level_reference(
                tables, o, d, w, acc, last), iters=2, warmup=1))
            reached = soft_reached(tables, gates, o, d)
            r["reached"].append(reached / n)
            bound, by = soft_bound(soft_level_ops(counts, reached, n, last), 20, n)
            r["bound_ms"].append(bound)
            r["bound_by"].append(by)
            levels.append((o, d, w, want_out[4], reached, order))
            acc, w, o, d = want_out[0], want_out[1], want_out[2], want_out[3]
    gen = torch.Generator(device=device).manual_seed(0)
    ct = V3(*(torch.randn(w.shape, generator=gen, device=device) for _ in range(3)))
    sums_k = torch.zeros(tables.packed.shape, dtype=torch.float64, device=device)
    sums_r = torch.zeros_like(sums_k)
    ct_next = None
    for k in (1, 0):
        o, d, w, res, reached, order = levels[k]
        last = k == 1
        got = cuda_soft.soft_level_bwd(tables, gates, o, d, w, res, ct, ct_next, last, sums_k)
        sums_o = torch.zeros_like(sums_k)
        got_o = cuda_soft.soft_level_bwd(tables, gates, o, d, w, res, ct, ct_next, last, sums_o,
                                         order=order)
        before = sums_r.clone()
        want = cuda_soft.soft_level_bwd_reference(tables, o, d, w, res, ct, ct_next, last, sums_r)
        r["bwd_rel"].append(max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                                for a, b in zip(got, want)))
        r["order_bwd_rel"].append(max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                                      for a, b in zip(got_o, want)))
        r["order_table_rel"].append(table_rel_err(tables, sums_o, sums_r - before)[0])
        reps = [torch.zeros_like(sums_k) for _ in range(2)]
        cts = [cuda_soft.soft_level_bwd(tables, gates, o, d, w, res, ct, ct_next, last, t,
                                        order=order) for t in reps]
        r["repeat_identical"].append(torch.equal(*reps)
                                     and all(torch.equal(a, b) for a, b in zip(*cts)))
        scratch = torch.zeros_like(sums_k)
        r["bwd_ms"].append(event_ms(lambda: cuda_soft.soft_level_bwd(
            tables, gates, o, d, w, res, ct, ct_next, last, scratch), iters=5, warmup=1))
        r["bwd_plain_ms"].append(event_ms(lambda: cuda_soft.soft_level_bwd_reference(
            tables, o, d, w, res, ct, ct_next, last, scratch), iters=1, warmup=1))
        n_carry = 5 if last else 15
        bound, by = soft_bound(soft_level_bwd_ops(counts, reached, n, last),
                               7 + 1 + n_carry + 3 + (0 if last else 7) + 7, n)
        r["bwd_bound_ms"].append(bound)
        r["bwd_bound_by"].append(by)
        ct_next = want
    for key in ("bwd_rel", "bwd_ms", "bwd_plain_ms", "bwd_bound_ms", "bwd_bound_by",
                "order_bwd_rel", "order_table_rel", "repeat_identical"):
        r[key].reverse()
    table_rel, table_err, worst = table_rel_err(tables, sums_k, sums_r)
    r["table_rel"], r["table_err"], r["table_worst"] = table_rel, table_err, worst
    r["fwd_ok"] = max(r["fwd_rel"]) <= 1e-6
    r["bwd_ok"] = (max(r["bwd_rel"]) <= SOFT_BWD_TOL and table_rel <= SOFT_TABLE_TOL
                   and all(r["repeat_identical"]))
    r["order_ok"] = (all(r["order_identical"]) and max(r["order_bwd_rel"]) <= SOFT_BWD_TOL
                     and max(r["order_table_rel"]) <= SOFT_TABLE_TOL)
    r["ok"] = r["fwd_ok"] and r["bwd_ok"] and r["order_ok"]
    return r


def table_rel_err(tables, got: torch.Tensor, want: torch.Tensor):
    """(the largest error of a packed-table cotangent relative to its
    array's largest entry in ``want``, the largest absolute error, the
    array of the largest relative one)."""
    table_rel, table_err, worst = 0.0, 0.0, None
    for key, (off, size) in tables.layout.items():
        a, b = got[off:off + size], want[off:off + size]
        err = float((a - b).abs().max())
        table_err = max(table_err, err)
        rel = err / float(b.abs().max()) if float(b.abs().max()) else (float("inf") if err else 0.0)
        if rel > table_rel:
            table_rel, worst = rel, key
    return table_rel, table_err, worst


def print_soft(r: dict):
    print(
        f"soft_level {r['name']} ({r['n_s']} spheres): ok={r['fwd_ok']} "
        f"identical={r['fwd_identical']} max_abs_err={max(r['fwd_err']):.3g} "
        f"max_rel_err={max(r['fwd_rel']):.3g} ms={[round(v, 4) for v in r['ms']]} "
        f"ms_res={[round(v, 4) for v in r['ms_res']]} "
        f"plain_ms={[round(v, 2) for v in r['plain_ms']]} "
        f"bound_ms={[round(v, 4) for v in r['bound_ms']]} ({r['bound_by']}) "
        f"reached_chunks_per_lane={[round(v, 3) for v in r['reached']]}", flush=True,
    )
    print(
        f"soft_level_bwd {r['name']}: ok={r['bwd_ok']} plane_max_rel_err="
        f"{[float(f'{v:.3g}') for v in r['bwd_rel']]} table_max_rel_err={r['table_rel']:.3g} "
        f"(array {r['table_worst']}) "
        f"table_max_abs_err={r['table_err']:.3g} repeat_identical={r['repeat_identical']} "
        f"ms={[round(v, 4) for v in r['bwd_ms']]} "
        f"plain_ms={[round(v, 1) for v in r['bwd_plain_ms']]} "
        f"bound_ms={[round(v, 4) for v in r['bwd_bound_ms']]} ({r['bwd_bound_by']})",
        flush=True,
    )
    print(
        f"soft lane order {r['name']}: ok={r['order_ok']} "
        f"soft_level_identical={r['order_identical']} soft_level_bwd_plane_max_rel_err="
        f"{[float(f'{v:.3g}') for v in r['order_bwd_rel']]} table_max_rel_err="
        f"{[float(f'{v:.3g}') for v in r['order_table_rel']]}", flush=True,
    )


def _on_cuda(args) -> bool:
    """Whether the first tensor (or V3 of tensors) among ``args`` is on CUDA."""
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.is_cuda
        if isinstance(a, tuple) and a and isinstance(a[0], torch.Tensor):
            return a[0].is_cuda
    return False


class PlainOnCuda:
    """Counts calls of the kernels' plain versions on CUDA tensors while it
    is entered (the wrappers look them up at call time): the soft kernels',
    the per-level chain's and the closest-hit kernels'."""

    names = {
        "cuda_soft": ("soft_level_reference", "soft_level_bwd_reference"),
        "cuda_level": ("ray_stats_reference", "trace_level_reference"),
        "cuda_hit": ("fold_flat_reference", "fold_shortlist_reference",
                     "fold_shortlist_hit_reference"),
    }

    def __enter__(self):
        import importlib

        self.calls, self.saved = 0, []
        for module, names in self.names.items():
            mod = importlib.import_module(f"raytracer_tpu_torch.ops.{module}")
            for name in names:
                fn = getattr(mod, name)
                self.saved.append((mod, name, fn))

                def counted(*args, _fn=fn, **kwargs):
                    self.calls += int(_on_cuda(args))
                    return _fn(*args, **kwargs)

                setattr(mod, name, counted)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def soft_fit_start(device, n: int = 64, width: int = 1920, height: int = 1080):
    """The soft fit's inputs: grid-``n``, the camera, the true scene's soft
    render (tau 0.01, depth 1) as the target, the centres moved by up to
    0.15 (numpy seed 0)."""
    from raytracer_tpu_torch import default_params, merge_params, render_soft
    from raytracer_tpu_torch.models import scenes

    truth = scenes.grid_sphere_scene(n, device=device)
    camera = scenes.reference_demo_camera(device=device)
    with torch.no_grad():
        target = render_soft(truth, camera, width, height, tau=SOFT_TAU, tau_z=SOFT_TAU_Z,
                             depth=1, device=device)
    pert = np.random.default_rng(0).uniform(-0.15, 0.15, (n, 3)).astype(np.float32)
    center = default_params(truth)["center"] + torch.from_numpy(pert).to(device)
    return truth, merge_params(truth, {"center": center}), camera, target


def _calls_ms(fn, iters: int) -> float:
    from raytracer_tpu_torch.utils.profiler import _calls_ms

    return _calls_ms(fn, iters)


def drive_soft_render(device, width: int = 1920, height: int = 1080) -> dict:
    """``render_soft`` of c4 (grid-64, 1920x1080, depth 1) through the public
    entry point, the launch counts set to 0 just before and read just
    after: 2 ``soft_level`` launches and nothing else, no plain version on
    CUDA, a finite image in [0, 1)."""
    from raytracer_tpu_torch import render_soft
    from raytracer_tpu_torch.models import scenes

    scene = scenes.grid_sphere_scene(64, device=device)
    camera = scenes.reference_demo_camera(device=device)
    with PlainOnCuda() as plain, torch.no_grad():
        reset_launches()
        img = render_soft(scene, camera, width, height, tau=SOFT_TAU, tau_z=SOFT_TAU_Z,
                          depth=1, device=device)
        torch.cuda.synchronize()
        launches = read_launches()
    stats = image_stats(img)
    # A 1-D batch of rays takes the kernels too (any shape is lanes).
    from raytracer_tpu_torch import V3, trace_soft
    from raytracer_tpu_torch.ops.trace import raygen_tile

    o, d = raygen_tile(camera, 64, 16)
    batch = [c.broadcast_to(d.x.shape).reshape(-1) for c in (*o, *d)]
    with PlainOnCuda() as plain_1d, torch.no_grad():
        reset_launches()
        rgb = trace_soft(scene, V3(*batch[:3]), V3(*batch[3:]), tau=SOFT_TAU, tau_z=SOFT_TAU_Z,
                         depth=1)
        torch.cuda.synchronize()
        batch_ok = (read_launches() == launches_of(soft_level=2) and plain_1d.calls == 0
                    and rgb.x.shape == (1024,) and bool(torch.isfinite(rgb.stacked()).all()))
    ok = (launches == launches_of(soft_level=2) and plain.calls == 0
          and stats["shape"] == (height, width, 3) and stats["nonfinite"] == 0
          and stats["range_ok"] and batch_ok)

    def frame():
        with torch.no_grad():
            render_soft(scene, camera, width, height, tau=SOFT_TAU, tau_z=SOFT_TAU_Z,
                        depth=1, device=device)

    frame()
    times = [_calls_ms(frame, 1) for _ in range(10)]  # nothing queued ahead of a frame
    return dict(launches=launches, plain_calls=plain.calls, image=stats, batch_1d_ok=batch_ok,
                ok=ok, frame_ms=statistics.median(times), frame_ms_all=times)


def span_medians(device, frames: int = 20, steps: int = 20) -> dict:
    """The span registry's medians a request (``utils/profiler.py``) over
    ``frames`` c5 frames (grid-1024 3840x2160 d4, each waited for, as the
    render cell runs them) and ``steps`` c4 soft fit steps (grid-64
    1920x1080 d1, back to back), recorded with ``profiler.recording()``
    after a warm-up of each: the milliseconds of each span name summed over
    a request, ``self``: the request's self time, and each counter."""
    from raytracer_tpu_torch import make_fit_step, render
    from raytracer_tpu_torch.models import scenes
    from raytracer_tpu_torch.utils import profiler

    grid = scenes.grid_sphere_scene(1024, device=device)
    camera = scenes.reference_demo_camera(device=device)
    _, start, soft_camera, target = soft_fit_start(device)
    init_fn, step_fn = make_fit_step(1920, 1080, depth=1, soft=True, device=device)
    state = init_fn(start)
    work = {"c5 frame": lambda: render(grid, camera, 3840, 2160, depth=4, device=device),
            "c4 soft fit step": lambda: step_fn(state, start, soft_camera, target)}
    out = {}
    for kind, fn in work.items():
        fn()
        torch.cuda.synchronize()
        profiler.reset()
        with profiler.recording():
            for _ in range(frames if kind == "c5 frame" else steps):
                fn()
                if kind == "c5 frame":
                    torch.cuda.synchronize()
        torch.cuda.synchronize()
        reqs = profiler.snapshot()["requests"]
        rows = [{**{k: v / 1e6 for k, v in profiler.span_totals_ns(r).items()},
                 "self": profiler.self_ns(r, r["name"]) / 1e6, **r["counters"]} for r in reqs]
        names = sorted({k for row in rows for k in row})
        out[kind] = {"requests": len(rows),
                     **{k: statistics.median(row.get(k, 0) for row in rows) for k in names}}
    return out


def drive_soft_fit(device, steps: int = 20, width: int = 1920, height: int = 1080) -> dict:
    """The soft fit at c4's full size through the public entry point:
    ``make_fit_step(1920, 1080, depth=1, soft=True)`` (tau 0.01, tau_z 0.05,
    Adam 2e-2 on the centres and colours), ``steps`` steps from the moved
    centres toward the true scene's soft render, the launch counts set to 0
    just before the run and read just after, and around each step. Each
    step launches each soft kernel depth + 1 = 2 times, no other kernel and
    no plain version on CUDA; the loss and the mean centre error fall."""
    from raytracer_tpu_torch import make_fit_step

    truth, start, camera, target = soft_fit_start(device, width=width, height=height)
    init_fn, step_fn = make_fit_step(width, height, depth=1, soft=True, device=device)
    state = init_fn(start)
    losses, errors, per_step = [], [], []
    with PlainOnCuda() as plain:
        reset_launches()
        for _ in range(steps):
            before = read_launches()
            state, loss = step_fn(state, start, camera, target)
            losses.append(float(loss))
            errors.append(float((state.params["center"].detach()
                                 - truth.spheres.center).abs().mean()))
            after = read_launches()
            per_step.append({k: after[k] - before[k] for k in after})
        torch.cuda.synchronize()
        launches = read_launches()
    ok = (all(p == launches_of(soft_level=2, soft_level_bwd=2) for p in per_step)
          and plain.calls == 0 and all(np.isfinite(losses)) and losses[-1] < losses[0]
          and errors[-1] < errors[0]
          and all(bool(torch.isfinite(v).all()) for v in state.params.values()))
    return dict(launches=launches, per_step=per_step, losses=losses, errors=errors,
                plain_calls=plain.calls, ok=ok)


# ---------------------------------------------------------------------------
# The app phase: the user's entry points (app/cli.py, app/fit.py) on the card
# ---------------------------------------------------------------------------

# The JAX package's own 600-step c4 fit on its TPU (docs/fit_c4/metrics.jsonl):
# results of the same program, not times, printed beside the port's.
JAX_C4_FIT = {"loss_step1": 1.4152561780065298e-3, "center_err_step1": 0.07357753813266754,
              "final_loss": 1.884377525129821e-05, "final_center_err": 0.04098173603415489,
              "psnr_hard_db": 48.44}
C4_FIT_STEPS = 600
C4_FIT_BARS = {"final_loss": 4e-5, "final_center_err": 0.05, "psnr_hard_db": 46.0}


class ObservedFitSteps:
    """While entered, ``app/fit.py``'s fit steps are observed: around each
    ``step_fn`` call, the launch counts' change and a pair of CUDA events."""

    def __enter__(self):
        from raytracer_tpu_torch.app import fit as app_fit

        self.module, self.real, self.rows = app_fit, app_fit.make_fit_step, []

        def make(*args, **kwargs):
            init_fn, step_fn = self.real(*args, **kwargs)

            def step(*a, **kw):
                before = read_launches()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = step_fn(*a, **kw)
                end.record()
                after = read_launches()
                self.rows.append((start, end, {k: after[k] - before[k] for k in after}))
                return out

            return init_fn, step

        app_fit.make_fit_step = make
        return self

    def __exit__(self, *exc):
        self.module.make_fit_step = self.real

    def step_ms(self) -> list:
        torch.cuda.synchronize()
        return [start.elapsed_time(end) for start, end, _ in self.rows]


def run_cli(argv: list) -> tuple[int, str, dict]:
    """``app.cli.main(argv)`` with its standard output captured, the launch
    counts set to 0 just before and read just after."""
    from raytracer_tpu_torch.app.cli import main as cli_main

    buf = io.StringIO()
    reset_launches()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    torch.cuda.synchronize()
    return rc, buf.getvalue(), read_launches()


def psnr_db(img: torch.Tensor, ref: torch.Tensor) -> float:
    """``run_fit``'s score: 10 log10(1 / MSE) of the float images."""
    mse = float(torch.mean((img - ref) ** 2))
    return 10.0 * float(np.log10(1.0 / max(mse, 1e-12)))


def drive_app_fit(out_dir: Path) -> dict:
    """The c4 fit app in full through the command line: ``fit --config
    c4-fit-64sphere --steps 600`` (tau 2e-3 annealed from 8e-3, the hard
    target, the cosine schedule), each step with its launches and CUDA-event
    time; the artefacts, the metrics and the bars on the final loss, centre
    error and hard PSNR."""
    t0 = time.perf_counter()
    with ObservedFitSteps() as obs:
        rc, out, launches = run_cli(["fit", "--config", "c4-fit-64sphere", "--steps",
                                     str(C4_FIT_STEPS), "-o", str(out_dir)])
    seconds = time.perf_counter() - t0
    step_ms = obs.step_ms()
    lines = [json.loads(x) for x in (out_dir / "metrics.jsonl").read_text().splitlines()]
    final = lines[-1]
    losses = [x["loss"] for x in lines[:-1]]
    per_step_ok = all(p == launches_of(soft_level=2, soft_level_bwd=2) for _, _, p in obs.rows)
    files = ["target.png", "initial.png", "final.png", "final_hard.png", "metrics.jsonl",
             "checkpoint.npz"]
    r = dict(
        rc=rc, launches=launches, per_step_ok=per_step_ok, steps=len(obs.rows),
        files_ok=all((out_dir / f).is_file() for f in files),
        metrics_lines=len(lines), first=lines[0], final=final, seconds=seconds,
        loop_seconds=lines[-2]["elapsed_s"],
        step_ms_1_60=statistics.median(step_ms[:60]),
        step_ms_540_600=statistics.median(step_ms[-61:]),
        step_ms_all_median=statistics.median(step_ms), step_ms_sum=sum(step_ms),
        last_stdout=out.strip().splitlines()[-1],
    )
    r["ok"] = (rc == 0 and per_step_ok and r["steps"] == C4_FIT_STEPS
               and launches == launches_of(trace_whole=2, soft_level=2 * C4_FIT_STEPS + 4,
                                           soft_level_bwd=2 * C4_FIT_STEPS)
               and r["files_ok"] and len(lines) == C4_FIT_STEPS // 10 + 1 + 1
               and all(np.isfinite(losses)) and np.isfinite(final["final_loss"])
               and final["final_loss"] <= C4_FIT_BARS["final_loss"]
               and final["final_center_err"] <= C4_FIT_BARS["final_center_err"]
               and final["psnr_hard_db"] >= C4_FIT_BARS["psnr_hard_db"]
               and r["last_stdout"] == json.dumps(final))
    r["curve"] = [(x["step"], float(f"{x['loss']:.5g}"), float(f"{x['center_err']:.5g}"))
                  for x in lines[:-1]]
    return r


def drive_app_jax_state(out_dir: Path, device) -> dict:
    """The JAX package's fitted c4 state carried across
    (``from_jax_fit_checkpoint``): its step, the hard render of its
    parameters at 1920x1080 d1 scored against the port's target (within 0.5
    dB of the JAX package's 48.44), then saved with ``save_fit_state`` and
    resumed for 10 steps through ``run_fit`` (the loss stays <= 4e-5)."""
    from raytracer_tpu_torch import make_fit_step, merge_params, render
    from raytracer_tpu_torch.app.config import get_config
    from raytracer_tpu_torch.app.fit import cosine_decay, run_fit
    from raytracer_tpu_torch.utils.checkpoint import (
        from_jax_fit_checkpoint,
        restore_fit_state,
        save_fit_state,
    )

    root = Path(__file__).resolve().parent
    out_dir.mkdir(parents=True, exist_ok=True)
    rec = from_jax_fit_checkpoint(root / "docs" / "fit_c4" / "checkpoint.npz")
    cfg = get_config("c4-fit-64sphere")
    truth, camera = cfg.build_scene(device=device), cfg.build_camera(device=device)
    params = {k: torch.from_numpy(v).to(device) for k, v in rec.params.items()}
    with torch.no_grad():
        target = render(truth, camera, cfg.width, cfg.height, depth=cfg.depth, device=device)
        fitted = render(merge_params(truth, params), camera, cfg.width, cfg.height,
                        depth=cfg.depth, device=device)
    psnr = psnr_db(fitted, target)
    init_fn, _ = make_fit_step(cfg.width, cfg.height, depth=cfg.depth, soft=True, device=device)
    state = init_fn(truth)
    scheduler = torch.optim.lr_scheduler.LambdaLR(state.optimizer, cosine_decay(10))
    restore_fit_state(state, scheduler, rec)
    path = save_fit_state(out_dir / "jax_c4_state.npz", state, scheduler)
    reset_launches()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = run_fit(cfg, steps=10, soft_tau=2e-3, out_dir=out_dir / "resumed", resume=str(path),
                     device=device)
    torch.cuda.synchronize()
    launches = read_launches()
    lines = [json.loads(x) for x in (out_dir / "resumed" / "metrics.jsonl").read_text()
             .splitlines()]
    r = dict(step=rec.step, psnr_hard_db=psnr, rc=rc, resumed=lines, launches=launches)
    r["ok"] = (rec.step == 600 and abs(psnr - JAX_C4_FIT["psnr_hard_db"]) <= 0.5 and rc == 0
               and [x.get("step") for x in lines[:2]] == [601, 610]
               and all(x.get("loss", x.get("final_loss")) <= C4_FIT_BARS["final_loss"]
                       for x in lines)
               and launches == launches_of(trace_whole=2, soft_level=24, soft_level_bwd=20))
    return r


def drive_app_cli(out_dir: Path, device) -> dict:
    """The command line's other entry points on the card: ``render`` of c3
    (its PNG, read back with ``load_image``, equals ``to_u8`` of ``render``
    pixel for pixel; one ``trace_whole``), ``render --depth-only`` of c1 (one
    ``fold_shortlist_hit``; the PNG is the finite normalised depth of
    ``render_depth``), ``render`` of c5 on one card (mesh "auto": the
    per-level chain, 4 row chunks; its PNG equals ``to_u8`` of a
    ``render`` of the same config, which is not constant and has no more
    non-finite pixels than the main path's c5 check allows), ``--mesh 2,1`` refused in one
    process (it needs two ranks under torchrun), ``bench`` of c3
    with ``--fwd-bwd --trace`` (one JSON line; ``trace.json`` names both
    whole-trace kernels), and ``view`` of c2 for 3 frames (3 frames of ANSI,
    a log of both phases)."""
    from raytracer_tpu_torch import render, render_depth
    from raytracer_tpu_torch.app.cli import depth_image
    from raytracer_tpu_torch.app.config import get_config
    from raytracer_tpu_torch.io import load_image, to_u8

    r = {}
    c3 = get_config("c3-1080p-3bounce")
    rc, _, launches = run_cli(["render", "--config", c3.name, "-o", str(out_dir / "c3.png")])
    with torch.no_grad():
        want = render(c3.build_scene(device=device), c3.build_camera(device=device), c3.width,
                      c3.height, depth=c3.depth, device=device)
    r["render_c3"] = dict(launches=launches, ok=(
        rc == 0 and launches == launches_of(trace_whole=1)
        and np.array_equal(load_image(out_dir / "c3.png"), to_u8(want))))

    c1 = get_config("c1-depth-pass")
    rc, _, launches = run_cli(["render", "--config", c1.name, "--depth-only", "-o",
                               str(out_dir / "c1.png")])
    viz = depth_image(render_depth(c1.build_scene(device=device), c1.build_camera(device=device),
                                   c1.width, c1.height, device=device).cpu().numpy())
    r["render_c1_depth"] = dict(launches=launches, ok=(
        rc == 0 and launches == launches_of(fold_shortlist_hit=1) and np.isfinite(viz).all()
        and viz.max() == 1.0 and np.array_equal(load_image(out_dir / "c1.png"), to_u8(viz))))

    c5 = get_config("c5-4k-1024sphere")
    rc, _, launches = run_cli(["render", "--config", c5.name, "-o", str(out_dir / "c5.png")])
    with torch.no_grad():
        want = render(c5.build_scene(device=device), c5.build_camera(device=device), c5.width,
                      c5.height, depth=c5.depth, tonemap=c5.tonemap, fold=c5.fold,
                      device=device)
    stats = image_stats(want)
    r["render_c5"] = dict(launches=launches, image=stats, ok=(
        rc == 0 and launches == launches_of(ray_stats=4, trace_level=20)
        and stats["range_ok"] and stats["nonfinite"] <= 1e-5 * c5.width * c5.height
        and float(want[torch.isfinite(want)].std()) > 0.0
        and np.array_equal(load_image(out_dir / "c5.png"), to_u8(want))))

    try:
        run_cli(["render", "--config", "c2-sprint3-1bounce", "--mesh", "2,1", "-o",
                 str(out_dir / "mesh.png")])
        r["mesh_2_1_refused"] = False
    except ValueError as exc:  # one process: a 2x1 mesh needs two ranks
        r["mesh_2_1_refused"] = "torchrun" in str(exc)

    trace_dir = out_dir / "trace"
    rc, out, launches = run_cli(["bench", "--config", c3.name, "--fwd-bwd", "--trace",
                                 str(trace_dir)])
    lines = out.strip().splitlines()
    res = json.loads(lines[-1])
    text = (trace_dir / "trace.json").read_text()
    r["bench_c3"] = dict(
        launches=launches, frame_ms=res["frame_ms"], forward_ms=res["forward_ms"],
        backward_ms=res["backward_ms"], trace_mb=len(text) / 1e6,
        ok=(rc == 0 and len(lines) == 1 and res["config"] == c3.name
            and "trace_whole_kernel" in text and "trace_whole_bwd_kernel" in text))

    log = out_dir / "view.log"
    rc, out, launches = run_cli(["view", "--config", "c2-sprint3-1bounce", "--frames", "3",
                                 "--log", str(log)])
    report = log.read_text()
    r["view_c2"] = dict(launches=launches, ok=(
        rc == 0 and out.count("\x1b[H") == 3 and "\x1b[38;2;" in out
        and launches == launches_of(trace_whole=3)
        and "average raytracing time" in report and "average present time" in report))
    r["ok"] = r["mesh_2_1_refused"] and all(v["ok"] for k, v in r.items()
                                             if isinstance(v, dict))
    return r


def drive_app(device) -> dict:
    """The app phase: the c4 fit app, the JAX package's fitted state carried
    across, and the command line's render, depth pass, c5, mesh, bench and
    view, every kernel on the card (no plain version on CUDA)."""
    with tempfile.TemporaryDirectory() as tmp, PlainOnCuda() as plain:
        tmp = Path(tmp)
        fit = drive_app_fit(tmp / "fit")
        jax_state = drive_app_jax_state(tmp / "jax_state", device)
        cli = drive_app_cli(tmp, device)
    return dict(fit=fit, jax_state=jax_state, cli=cli, plain_calls=plain.calls,
                ok=fit["ok"] and jax_state["ok"] and cli["ok"] and plain.calls == 0)


def app_failures(app: dict) -> list:
    """The parts of the app phase that failed, by name."""
    parts = [k for k in ("fit", "jax_state") if not app[k]["ok"]]
    parts += [f"cli {k}" for k, v in app["cli"].items()
              if k != "ok" and not (v["ok"] if isinstance(v, dict) else v)]
    if app["plain_calls"]:
        parts.append(f"{app['plain_calls']} plain calls on CUDA")
    return parts


def print_app(app: dict):
    f, j = app["fit"], app["jax_state"]
    print(f"app c4 fit (cli fit --config c4-fit-64sphere --steps {C4_FIT_STEPS}, tau 2e-3): "
          f"ok={f['ok']} rc={f['rc']} launches={f['launches']} "
          f"per_step soft_level 2 + soft_level_bwd 2 only={f['per_step_ok']} steps={f['steps']} "
          f"files_ok={f['files_ok']} metrics_lines={f['metrics_lines']}", flush=True)
    print(f"app c4 fit results (port on the card; JAX package's TPU run in brackets): "
          f"step 1 loss {f['first']['loss']:.6g} [{JAX_C4_FIT['loss_step1']:.6g}] "
          f"center_err {f['first']['center_err']:.6g} [{JAX_C4_FIT['center_err_step1']:.6g}]; "
          f"final loss {f['final']['final_loss']:.6g} [{JAX_C4_FIT['final_loss']:.6g}] "
          f"center_err {f['final']['final_center_err']:.6g} "
          f"[{JAX_C4_FIT['final_center_err']:.6g}] psnr_hard_db {f['final']['psnr_hard_db']} "
          f"[{JAX_C4_FIT['psnr_hard_db']}]; bars {C4_FIT_BARS}", flush=True)
    print(f"app c4 fit metrics (step, loss, center_err): {f['curve']}", flush=True)
    print(f"app c4 fit step ms (CUDA events around step_fn): median steps 1-60 "
          f"{f['step_ms_1_60']:.4f}, steps 540-600 {f['step_ms_540_600']:.4f}, all "
          f"{f['step_ms_all_median']:.4f}, sum {f['step_ms_sum'] / 1e3:.3f} s; the {f['steps']} steps' "
          f"loop {f['loop_seconds']} s (host clock, metrics.jsonl); whole run {f['seconds']:.2f} s",
          flush=True)
    print(f"app JAX c4 state carried across: ok={j['ok']} step={j['step']} "
          f"hard psnr_db={j['psnr_hard_db']:.4f} [JAX {JAX_C4_FIT['psnr_hard_db']}] "
          f"resumed 10 steps: {j['resumed']} launches={j['launches']}", flush=True)
    for name, v in app["cli"].items():
        print(f"app cli {name}: {v}", flush=True)
    print(f"app plain versions called on CUDA: {app['plain_calls']}; ok={app['ok']}", flush=True)


# ---------------------------------------------------------------------------
# The distribution phase (parallel/): the sharded paths on a one-rank NCCL
# group, then on two gloo ranks that share the one card
# ---------------------------------------------------------------------------

# Seconds the two-rank run may take, spawn and CUDA start-up included; past
# them ``spawn`` ends both ranks and raises. (Each collective on its own waits
# at most ``parallel.mesh.TIMEOUT_S`` for its peers.)
DIST_TIMEOUT_S = 240.0
# The CPU tests' tolerances for a meshed fit step against the single-rank
# step (tests/test_torch_sharded.py, after the JAX package's
# tests/test_parallel.py): (loss rtol, parameter atol, gradient error as a
# share of the leaf's largest gradient).
DIST_FIT_TOL = {"hard": (1e-5, 1e-5, 1e-5), "soft": (1e-4, 2e-5, 1e-4)}
# (width, height, depth): c5 (grid-1024) on the one-rank mesh; sprint3 there,
# and grid-1024 and the fit steps on two ranks (the c4 soft fit at depth 1).
DIST_C5 = (3840, 2160, 4)
DIST_FRAME = (1920, 1080, 3)


def calls_event_ms(fn, iters: int) -> list:
    """CUDA-event milliseconds of each of ``iters`` calls of ``fn``, each
    started with nothing queued ahead and ended by its last device op."""
    out = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def in_turns(fns: dict, iters: int) -> dict:
    """``calls_event_ms`` of two calls (a dict of two), timed in turns
    (a, b, b, a), ``iters`` calls a turn: each name's milliseconds."""
    a, b = fns
    out = {a: [], b: []}
    for name in (a, b, b, a):
        out[name] += calls_event_ms(fns[name], iters)
    return out


def counted_call(fn):
    """``fn()`` with every kernel's launch count set to 0 just before and
    read just after: (its result, the counts)."""
    reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, read_launches()


def fit_steps(make, start, camera, target, steps: int) -> dict:
    """``steps`` steps of ``make()``'s ``(init_fn, step_fn)`` from ``start``:
    each step's loss (a tensor), the launches of each step, the final
    parameters (detached clones) and the gradients the last step took."""
    init_fn, step_fn = make()
    state = init_fn(start)
    losses, per_step = [], []
    for _ in range(steps):
        (state, loss), launches = counted_call(lambda: step_fn(state, start, camera, target))
        losses.append(loss)
        per_step.append(launches)
    return dict(losses=losses, per_step=per_step,
                params={k: v.detach().clone() for k, v in state.params.items()},
                grads={k: v.grad.clone() for k, v in state.params.items()})


def fit_close(got: dict, want: dict, kind: str) -> dict:
    """A meshed fit step against the single-rank one, to ``DIST_FIT_TOL``:
    the loss, the parameters, and the gradients the step took (summed over
    the mesh), whose error is a share of the leaf's largest gradient (Adam's
    first update is about ``lr * sign(g)``, so the parameters alone would
    pass a gradient off by a scale)."""
    rtol, atol, gtol = DIST_FIT_TOL[kind]
    loss_g, loss_w = float(got["losses"][-1]), float(want["losses"][-1])
    err = {k: max_err(got["params"][k], want["params"][k]) for k in want["params"]}
    gerr = {k: max_err(got["grads"][k], g) / float(g.abs().max())
            for k, g in want["grads"].items()}
    finite = all(bool(torch.isfinite(v).all()) for v in got["params"].values())
    return dict(loss=loss_g, loss_single=loss_w, loss_rel_err=abs(loss_g - loss_w) / abs(loss_w),
                param_max_abs_err=err, grad_err_of_largest=gerr,
                launches_per_step=got["per_step"][-1],
                ok=(finite and abs(loss_g - loss_w) <= rtol * abs(loss_w)
                    and all(v <= atol for v in err.values())
                    and all(v <= gtol for v in gerr.values())))


def drive_dist_one_rank(device) -> dict:
    """World size 1 on NCCL (a ``tcp://127.0.0.1`` group of one rank, so
    that the mesh's collectives run through NCCL on the card): c5 (grid-1024
    3840x2160 d4) through ``render_sharded`` on the 1x1 mesh and through
    ``cli render --config c5-4k-1024sphere --mesh 1,1`` (the image equals
    ``render`` bit for bit, the PNG ``to_u8`` of it; ray_stats 4,
    trace_level 20 as ``render``), sprint3 1920x1080 d3 on the 1x1 mesh (bit
    for bit, one trace_whole), and three c4 soft fit steps (grid-64
    1920x1080 d1) with the 1x1 mesh against three without: the losses and
    the parameters bit-equal."""
    import torch.distributed as dist

    from raytracer_tpu_torch import make_fit_step, render, render_sharded
    from raytracer_tpu_torch.io import load_image, to_u8
    from raytracer_tpu_torch.models import scenes
    from raytracer_tpu_torch.parallel import comm, initialize_distributed, make_mesh
    from raytracer_tpu_torch.parallel.dryrun import free_port

    r = {}
    initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0, device=device)
    try:
        mesh = make_mesh(device=device)
        r["backend"] = dist.get_backend()
        camera = scenes.reference_demo_camera(device=device)
        grid = scenes.grid_sphere_scene(1024, device=device)
        cw, ch, cd = DIST_C5
        with torch.no_grad():
            want = render(grid, camera, cw, ch, depth=cd, device=device)
            with comm.census() as log:
                img, launches = counted_call(
                    lambda: render_sharded(grid, camera, cw, ch, mesh=mesh, depth=cd))
            ms = in_turns({
                "render": lambda: render(grid, camera, cw, ch, depth=cd, device=device),
                "render_sharded": lambda: render_sharded(grid, camera, cw, ch, mesh=mesh,
                                                         depth=cd)}, 3)
        r["c5"] = dict(launches=launches, same=same_planes(img, want), frame_ms=ms,
                       collectives=log, image=image_stats(img))
        r["c5"]["ok"] = (r["c5"]["same"] and img.shape == (ch, cw, 3)
                         and launches == launches_of(ray_stats=4, trace_level=20)
                         and log == [("all_gather", 1, cw * ch * 3, "torch.float32")])
        with tempfile.TemporaryDirectory() as tmp:
            png = Path(tmp) / "c5.png"
            rc, out, launches = run_cli(["render", "--config", "c5-4k-1024sphere", "--mesh",
                                         "1,1", "--width", str(cw), "--height", str(ch),
                                         "--device", str(device), "-o", str(png)])
            png_ok = np.array_equal(load_image(png), to_u8(want))
        r["cli_c5"] = dict(rc=rc, launches=launches, png_equal=png_ok, note="mesh=1x1" in out,
                           ok=(rc == 0 and png_ok and "mesh=1x1" in out
                               and launches == launches_of(ray_stats=4, trace_level=20)))
        sprint3 = scenes.sprint3_scene(device=device)
        w, h, depth = DIST_FRAME
        with torch.no_grad():
            want = render(sprint3, camera, w, h, depth=depth, device=device)
            img, launches = counted_call(
                lambda: render_sharded(sprint3, camera, w, h, mesh=mesh, depth=depth))
            ms = in_turns({
                "render": lambda: render(sprint3, camera, w, h, depth=depth, device=device),
                "render_sharded": lambda: render_sharded(sprint3, camera, w, h, mesh=mesh,
                                                         depth=depth)}, 5)
        r["sprint3"] = dict(launches=launches, same=same_planes(img, want), frame_ms=ms,
                            ok=same_planes(img, want) and launches == launches_of(trace_whole=1))
        _, start, camera, target = soft_fit_start(device, width=w, height=h)
        runs = {}
        for name, m in (("single", None), ("mesh_1x1", mesh)):
            with comm.census() as log:
                runs[name] = fit_steps(
                    lambda m=m: make_fit_step(w, h, depth=1, soft=True, device=device,
                                              mesh=m), start, camera, target, 3)
            runs[name]["collectives"] = len(log)
        one, single = runs["mesh_1x1"], runs["single"]
        same = (all(torch.equal(a, b) for a, b in zip(one["losses"], single["losses"]))
                and all(torch.equal(one["params"][k], v) for k, v in single["params"].items()))
        r["c4_fit"] = dict(losses=[float(v) for v in one["losses"]], bit_equal=same,
                           launches_per_step=one["per_step"],
                           collectives_3_steps=one["collectives"],
                           ok=(same and one["collectives"] == 3 * 3
                               and all(p == launches_of(soft_level=2, soft_level_bwd=2)
                                       for p in one["per_step"])))
    finally:
        dist.destroy_process_group()
    r["ok"] = all(v["ok"] for v in r.values() if isinstance(v, dict))
    return r


def dist_two_ranks(device: str, frame=DIST_FRAME) -> dict:
    """One of two gloo ranks on the one card (``parallel/dryrun.spawn``):
    grid-1024 1920x1080 d3 on a (2, 1) mesh (the gathered image against
    ``render``, bit for bit; ray_stats 1 and trace_level 4 a rank) and on a
    (1, 2) mesh (every level's combined (t, index) and the image against
    the single-rank per-level loop around ``closest_hit_soa``, bit for bit;
    the image within 1e-4 of ``render``; fold_shortlist_hit 4 a rank; the
    bytes the hit combine moves a level); then one hard fit step at (2, 1)
    on sprint3 1920x1080 d3 and one on grid-1024 (``level_fit_optimizer``),
    and one c4 soft fit step, each against the single-rank step on this
    rank to ``DIST_FIT_TOL``. Each mesh's frame time from CUDA events around
    the whole call, on this rank."""
    import torch.distributed as dist

    from raytracer_tpu_torch import closest_hit_soa, make_fit_step, render, render_sharded
    from raytracer_tpu_torch.models import scenes
    from raytracer_tpu_torch.ops.tonemap import reinhard_tonemap
    from raytracer_tpu_torch.ops.trace import render_tile
    from raytracer_tpu_torch.parallel import comm, make_mesh
    from raytracer_tpu_torch.parallel import render as prender

    r = {"rank": dist.get_rank(), "backend": dist.get_backend()}
    mesh21 = make_mesh(2, 1, device=device)
    mesh12 = make_mesh(1, 2, device=device)
    camera = scenes.reference_demo_camera(device=device)
    grid = scenes.grid_sphere_scene(1024, device=device)
    w, h, depth = frame
    with torch.no_grad():
        want = render(grid, camera, w, h, depth=depth, device=device)
        img, launches = counted_call(
            lambda: render_sharded(grid, camera, w, h, mesh=mesh21, depth=depth))
        ms = calls_event_ms(lambda: render_sharded(grid, camera, w, h, mesh=mesh21, depth=depth), 5)
        r["px_2x1"] = dict(launches=launches, same=same_planes(img, want), frame_ms=ms,
                           ok=(same_planes(img, want)
                               and launches == launches_of(ray_stats=1, trace_level=4)))

        levels, combine = [], prender._combine_hits

        def recorded(rec, group):
            out = combine(rec, group)
            levels.append((out.t.clone(), out.prim_index.clone()))
            return out

        prender._combine_hits = recorded
        try:
            with comm.census() as log:
                img, launches = counted_call(
                    lambda: render_sharded(grid, camera, w, h, mesh=mesh12, depth=depth))
        finally:
            prender._combine_hits = combine
        ms = calls_event_ms(lambda: render_sharded(grid, camera, w, h, mesh=mesh12, depth=depth), 3)
        ref_levels = []

        def hit(sc, o, d, active=None):
            rec = closest_hit_soa(sc, o, d, active=active)
            ref_levels.append((rec.t, rec.prim_index))
            return rec

        loop = reinhard_tonemap(render_tile(grid, camera, w, h, depth=depth,
                                            closest_hit_fn=hit).stacked())
    levels_same = len(levels) == len(ref_levels) == depth + 1 and all(
        same_planes(a[0], b[0]) and torch.equal(a[1], b[1]) for a, b in zip(levels, ref_levels))
    finite = torch.isfinite(img) & torch.isfinite(want)
    near = torch.where(finite, (img - want).abs() <= 1e-4,
                       (torch.isfinite(img) == torch.isfinite(want)))
    level_bytes = sum(n * 4 for _, _, n, _ in log[:-1]) / (depth + 1)
    r["prim_1x2"] = dict(
        launches=launches, levels_same=levels_same, same_as_loop=same_planes(img, loop),
        pixels_past_1e4_of_render=int((~near.all(dim=-1)).sum()),
        max_abs_err_to_render=max_err(img[finite], want[finite]), frame_ms=ms,
        collectives_a_level=log[:3], combine_bytes_a_level=level_bytes,
        ok=(levels_same and same_planes(img, loop) and bool(near.all())
            and launches["fold_shortlist_hit"] == depth + 1
            and all(v == 0 for k, v in launches.items()
                    if k not in ("fold_shortlist_hit", "ray_stats"))))

    fits = {}
    for name, (start, target, kw, kind) in {
            "hard_sprint3": (*fit_start(device, w, h)[::2], {"depth": depth}, "hard"),
            "hard_grid1024": (*level_fit_start(device, w, h)[::2],
                              {"depth": depth, "optimizer": level_fit_optimizer}, "hard"),
            "soft_c4": (*soft_fit_start(device, width=w, height=h)[1::2],
                        {"depth": 1, "soft": True}, "soft"),
    }.items():
        runs = [fit_steps(lambda m=m: make_fit_step(w, h, device=device, mesh=m, **kw),
                          start, camera, target, 1) for m in (mesh21, None)]
        fits[name] = fit_close(*runs, kind)
    r["fits_2x1"] = fits
    r["ok"] = (r["px_2x1"]["ok"] and r["prim_1x2"]["ok"]
               and all(v["ok"] for v in fits.values()))
    return r


def drive_dist(device) -> dict:
    """The distribution phase: ``drive_dist_one_rank`` in this process,
    then ``dist_two_ranks`` on two spawned gloo ranks on ``device``."""
    from raytracer_tpu_torch.parallel.dryrun import spawn

    one = drive_dist_one_rank(device)
    t0 = time.perf_counter()
    two = spawn(dist_two_ranks, 2, args=(device,), device=device, backend="gloo",
                timeout_s=DIST_TIMEOUT_S)
    return dict(one_rank=one, two_ranks=two, two_ranks_seconds=time.perf_counter() - t0,
                ok=one["ok"] and all(r["ok"] for r in two))


def dist_failures(d: dict) -> list:
    """The parts of the distribution phase that failed, by name."""
    parts = [f"one rank {k}" for k, v in d["one_rank"].items()
             if isinstance(v, dict) and not v["ok"]]
    for r in d["two_ranks"]:
        parts += [f"rank {r['rank']} of 2 {k}" for k in ("px_2x1", "prim_1x2") if not r[k]["ok"]]
        parts += [f"rank {r['rank']} of 2 fit {k}" for k, v in r["fits_2x1"].items()
                  if not v["ok"]]
    return parts


def _rounded(times: dict) -> dict:
    return {k: [round(v, 4) for v in vs] for k, vs in times.items()}


def print_dist(d: dict, smi: str):
    one = d["one_rank"]
    print(f"dist one rank ({one['backend']}, world 1, 1x1 mesh): c5 grid1024 3840x2160 d4 "
          f"render_sharded: ok={one['c5']['ok']} bit_equal_render={one['c5']['same']} "
          f"launches={one['c5']['launches']} collectives={one['c5']['collectives']} "
          f"image={one['c5']['image']} frame_ms in turns (render, sharded, sharded, render; "
          f"CUDA events) {_rounded(one['c5']['frame_ms'])}; "
          f"cli render --mesh 1,1: {one['cli_c5']}", flush=True)
    print(f"dist one rank sprint3 1920x1080 d3 render_sharded: ok={one['sprint3']['ok']} "
          f"bit_equal_render={one['sprint3']['same']} launches={one['sprint3']['launches']} "
          f"frame_ms in turns {_rounded(one['sprint3']['frame_ms'])}", flush=True)
    print(f"dist one rank c4 soft fit, 3 steps with the 1x1 mesh against 3 without: "
          f"{one['c4_fit']}", flush=True)
    for r in d["two_ranks"]:
        px, prim = r["px_2x1"], r["prim_1x2"]
        print(f"dist rank {r['rank']} of 2 ({r['backend']}, both ranks on one card: no scaling "
              f"figure) grid1024 1920x1080 d3 mesh 2x1: ok={px['ok']} bit_equal_render="
              f"{px['same']} launches={px['launches']} frame_ms="
              f"{[round(v, 4) for v in px['frame_ms']]}", flush=True)
        print(f"dist rank {r['rank']} of 2 grid1024 1920x1080 d3 mesh 1x2: ok={prim['ok']} "
              f"levels_equal_single_rank_loop={prim['levels_same']} "
              f"image_equal_loop={prim['same_as_loop']} pixels_past_1e-4_of_render="
              f"{prim['pixels_past_1e4_of_render']} max_abs_err_to_render="
              f"{prim['max_abs_err_to_render']:.3g} launches={prim['launches']} "
              f"collectives_a_level={prim['collectives_a_level']} combine_bytes_a_level="
              f"{prim['combine_bytes_a_level']:.0f} frame_ms="
              f"{[round(v, 4) for v in prim['frame_ms']]}", flush=True)
        for name, f in r["fits_2x1"].items():
            print(f"dist rank {r['rank']} of 2 fit step mesh 2x1 {name}: {f}", flush=True)
    print(f"dist two ranks: {d['two_ranks_seconds']:.1f} s with spawn and start-up; "
          f"card {smi}; ok={d['ok']}", flush=True)


# ---------------------------------------------------------------------------
# The hard path's bounce: the upstream's reflect on every hard route
# ---------------------------------------------------------------------------

# Pixels (row, column) of c5's frame (grid-1024, 3840x2160, depth 4, the
# demo camera) that were not finite while the bounce took the float32 normal
# as it came, and seeds whose c5 hard fit's first loss was NaN then.
F1_PIXELS = ((1026, 536), (1046, 672), (1088, 276), (1548, 687))
F1_SEEDS = (5000000001, 6000000001, 6000000002)
# The bounce checks' workloads: the whole-trace route (grid-64) and the
# per-level chain (grid-1024), each frame's first GRAZE_ROWS rows planted to
# graze the spheres (``grazing_rays``).
BOUNCE_CASES = (
    ("grid64_1920x1080_d4", ("grid_sphere_scene", (64,)), 1920, 1080, 4),
    ("grid1024_1920x1080_d4", ("grid_sphere_scene", (1024,)), 1920, 1080, 4),
)
GRAZE_ROWS = 128
# The largest | |d| - 1 | of a level's direction the bounce may leave.
UNIT_TOL = 1e-6


def grazing_rays(scene, width: int, height: int, device, rows: int = GRAZE_ROWS):
    """The demo camera's rays at ``width`` x ``height`` (``frame_rays``) with
    the first ``rows`` rows replaced by rays from its eye that pass the
    scene's spheres at 0.9 to 0.9999999 of the radius from the centre, on 16
    sides of each, cycling over the spheres."""
    from raytracer_tpu_torch.core.v3 import V3

    o, d, w = frame_rays(width, height, device)
    eye = torch.stack([o.x[0, 0], o.y[0, 0], o.z[0, 0]]).double()
    k = torch.arange(rows * width, device=device)
    n_s = scene.spheres.radius.shape[0]
    impact = torch.tensor([0.9, 0.99, 0.999, 0.9999, 0.99999, 0.999999, 0.9999999],
                          dtype=torch.float64, device=device)
    sph, imp = k % n_s, impact[(k // n_s) % len(impact)]
    phi = ((k // (n_s * len(impact))) % 16).double() * (np.pi / 8)
    c = scene.spheres.center.double()[sph]
    r = scene.spheres.radius.double()[sph]
    axis = c - eye
    axis = axis / axis.norm(dim=-1, keepdim=True)
    z = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64, device=device).expand_as(axis)
    u = torch.linalg.cross(axis, z)
    u = u / u.norm(dim=-1, keepdim=True)
    v = torch.linalg.cross(axis, u)
    aim = c + (r * imp)[:, None] * (torch.cos(phi)[:, None] * u + torch.sin(phi)[:, None] * v)
    g = aim - eye
    g = (g / g.norm(dim=-1, keepdim=True)).float()
    planes = [p.clone() for p in d]
    for j in range(3):
        planes[j][:rows] = g[:, j].reshape(rows, width)
    return o, V3(*planes), w


def unit_error(res: torch.Tensor) -> list:
    """Per level 1..depth, the largest ``| |d| - 1 |`` over the lanes alive
    there (``res``: the residual planes, ``[depth, 7, ...]``)."""
    out = []
    for r in res:
        alive = r[6] > 0
        dev = (r[3:6].double().square().sum(dim=0).sqrt() - 1.0).abs()
        out.append(float(dev[alive].max()) if bool(alive.any()) else 0.0)
    return out


def bounce_routes(device) -> dict:
    """The changed kernels against their plain versions on frames with
    grazing rays: ``trace_whole`` and ``trace_whole_bwd`` on grid-64 at d4,
    ``ray_stats``, ``trace_level`` and ``trace_level_bwd`` on grid-1024 at
    d4 (``check_trace_whole``, ``check_trace_whole_bwd``, ``check_levels``);
    each route's largest ``| |d| - 1 |`` a level; the per-level loop around
    ``closest_hit_soa`` (the shortlist-hit kernel) on the grid-1024 frame
    against the chain's image and its own directions."""
    from raytracer_tpu_torch.ops import cuda_fold, cuda_level
    from raytracer_tpu_torch.ops.trace import closest_hit_soa, trace_soa

    out = {}
    whole, chain = BOUNCE_CASES
    scene = make_scene(whole[1], device)
    rays = grazing_rays(scene, whole[2], whole[3], device)
    r = check_trace_whole(whole, device, rays=rays)
    fwd = r.pop("forward")
    r["unit_error"] = unit_error(fwd["levels"].res)
    b = check_trace_whole_bwd(fwd, whole[0], device)
    out["whole"] = {"fwd": {k: v for k, v in r.items() if k != "mismatch_lines"},
                    "bwd": {k: v for k, v in b.items() if k != "exceptions"}}
    out["whole"]["ok"] = r["ok"] and b["ok"] and max(r["unit_error"]) <= UNIT_TOL

    scene = make_scene(chain[1], device)
    o, d, w = grazing_rays(scene, chain[2], chain[3], device)
    lv = check_levels(chain, device, rays=(o, d, w))
    tables = cuda_fold.fused_tables(scene)
    rgb, _, _, res = cuda_level.trace_levels(tables, o, d, w, chain[4], emit_res=True)
    lv["unit_error"] = unit_error(res)
    seen = []

    def hit_fn(sc, oo, dd, active=None):
        if active is not None:
            seen.append(torch.stack([*dd, active.float()]))
        return closest_hit_soa(sc, oo, dd, active=active)

    with torch.no_grad():
        reset_launches()
        loop = trace_soa(scene, o, d, depth=chain[4], closest_hit_fn=hit_fn)
        torch.cuda.synchronize()
        launches = read_launches()
    loop_err = unit_error(torch.stack([torch.cat([s[:3], s[:3], s[3:]]) for s in seen]))
    equal = torch.stack([same_mask(a, b) for a, b in zip(loop, rgb)]).all(dim=0)
    out["chain"] = lv
    out["chain"]["ok"] = lv["ok"] and max(lv["unit_error"]) <= UNIT_TOL
    out["loop"] = dict(equal_frac=float(equal.float().mean()), unit_error=loop_err,
                       launches=launches, finite=all(bool(torch.isfinite(c).all()) for c in loop))
    out["loop"]["ok"] = (out["loop"]["equal_frac"] >= 0.999 and max(loop_err) <= UNIT_TOL
                         and out["loop"]["finite"])
    out["planted"] = GRAZE_ROWS * chain[2]
    return out


def c5_frame(device) -> dict:
    """``render`` of c5 (grid-1024, 3840x2160, depth 4, the demo camera)
    without its tone map: its pixels that are not finite, its largest
    channel, F1_PIXELS' values, and the frame's time."""
    from raytracer_tpu_torch import render
    from raytracer_tpu_torch.models import scenes

    scene = scenes.grid_sphere_scene(1024, device=device)
    camera = scenes.reference_demo_camera(device=device)
    with torch.no_grad():
        img = render(scene, camera, 3840, 2160, depth=4, tonemap=False, device=device)
    torch.cuda.synchronize()
    bad = ~torch.isfinite(img).all(dim=-1)
    out = dict(nonfinite=int(bad.sum()), largest=float(img[~bad].max()),
               pixels={f"{r},{c}": [float(x) for x in img[r, c]] for r, c in F1_PIXELS})
    out["pixels_finite"] = all(np.isfinite(v).all() for v in out["pixels"].values())
    return out


def c5_fit(device, steps: int = 2, timed: int = 5) -> dict:
    """``make_fit_step(3840, 2160, depth=4)`` on grid-1024 from each of
    F1_SEEDS' start draws (the benchmark's ``inputs.start_draw``, truth +-
    U(0.15)) toward the true scene's frame: ``steps`` steps each, their
    losses, whether every loss and gradient is finite, the kernel launches
    a step, the peak of the card's memory over the steps; then ``timed``
    more steps of the last seed, their median host time to a synchronise."""
    from benchmark import inputs
    from raytracer_tpu_torch import Scene, make_fit_step, merge_params, render
    from raytracer_tpu_torch.models import scenes

    cfg = json.loads((Path(__file__).resolve().parent / "benchmark" / "configs"
                      / "grid-1024.json").read_text())
    arrays = inputs.scene_arrays(cfg)
    truth = Scene.from_numpy(arrays, device=device)
    camera = scenes.reference_demo_camera(device=device)
    with torch.no_grad():
        target = render(truth, camera, 3840, 2160, depth=4, device=device)
    init_fn, step_fn = make_fit_step(3840, 2160, depth=4, device=device)
    out = {}
    for seed in F1_SEEDS:
        start = inputs.start_draw(arrays, 0.15, inputs.seeded_generator(seed, device), device)
        state = init_fn(merge_params(truth, start))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, finite, per_step = [], True, []
        for _ in range(steps):
            reset_launches()
            state, loss = step_fn(state, truth, camera, target)
            losses.append(float(loss))
            per_step.append(read_launches())
            finite &= all(bool(torch.isfinite(p.grad).all()) for p in state.params.values())
            finite &= all(bool(torch.isfinite(p).all()) for p in state.params.values())
        out[str(seed)] = dict(losses=losses, finite=finite and all(np.isfinite(losses)),
                              launches=per_step,
                              peak_bytes=int(torch.cuda.max_memory_allocated()))
    times = []
    for _ in range(timed):
        a = time.perf_counter()
        state, _ = step_fn(state, truth, camera, target)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - a) * 1e3)
    out["step_ms"] = statistics.median(times)
    return out


def c5_kernel_times(device) -> dict:
    """The changed kernels' device times a launch (``event_ms``): at c5's
    full frame, ``trace_level`` a level and ``trace_level_bwd`` a level on
    the chain's residuals and a seeded cotangent; ``trace_whole`` (with and
    without its residual planes) and ``trace_whole_bwd`` on grid-768 and
    sprint3 at 1920x1080 d3."""
    from raytracer_tpu_torch.core.v3 import V3
    from raytracer_tpu_torch.ops import cuda_fold, cuda_level

    out = {}
    scene = make_scene(("grid_sphere_scene", (1024,)), device)
    tables = cuda_fold.fused_tables(scene)
    o, d, w = frame_rays(3840, 2160, device)
    km = level_kernels_ms(tables, o, d, w, 4)
    out["c5_ray_stats_ms"], out["c5_trace_level_ms"] = km["stats_ms"], km["level_ms"]
    _, t_k, i_k, res = cuda_level.trace_levels(tables, o, d, w, 4, emit_res=True)
    levels = cuda_fold.Residuals(o, d, w, t_k, i_k, res)
    attrs, ls = (a.detach() for a in cuda_fold.attribute_tables(scene))
    gen = torch.Generator().manual_seed(7)
    ct = V3(*(torch.randn(w.shape, generator=gen).to(device) for _ in range(3)))
    sums = (torch.zeros(attrs.shape, dtype=torch.float64, device=device),
            torch.zeros(ls.shape, dtype=torch.float64, device=device))
    out["c5_trace_level_bwd_ms"], ct_next = [], None
    for k in reversed(range(5)):
        lo, ld, lw = levels.level(k)
        cn = ct_next

        def launch():
            return cuda_level.trace_level_bwd(tables, attrs, ls, lo, ld, lw, t_k[k], i_k[k],
                                              ct, cn, k == 4, sums)

        out["c5_trace_level_bwd_ms"].insert(0, event_ms(launch, iters=10, warmup=2))
        ct_next = launch()
    for name, spec in (("grid768", ("grid_sphere_scene", (768,))),
                       ("sprint3", ("sprint3_scene", ()))):
        scene = make_scene(spec, device)
        tables = cuda_fold.fused_tables(scene)
        o, d, w = frame_rays(1920, 1080, device)
        out[f"trace_whole_{name}_ms"] = event_ms(lambda: cuda_fold.trace_whole(tables, o, d, w, 3))
        out[f"trace_whole_res_{name}_ms"] = event_ms(
            lambda: cuda_fold.trace_whole(tables, o, d, w, 3, emit_res=True))
        _, t_w, i_w, res = cuda_fold.trace_whole(tables, o, d, w, 3, emit_res=True)
        lv = cuda_fold.Residuals(o, d, w, t_w, i_w, res)
        attrs, ls = (a.detach() for a in cuda_fold.attribute_tables(scene))
        ct = V3(*(torch.randn(w.shape, generator=gen).to(device) for _ in range(3)))
        out[f"trace_whole_bwd_{name}_ms"] = event_ms(
            lambda: cuda_fold.trace_whole_bwd(tables, attrs, ls, lv, ct, 3))
    return out


def bounce_only() -> int:
    """``--bounce-only [--root DIR]``: the card's line, the build of the
    hard path's kernels, ``bounce_routes``, c5's frame and fit (F1's repro,
    ``c5_frame``, ``c5_fit``) and the changed kernels' times
    (``c5_kernel_times``) on the package at DIR (default: beside this
    script), then one JSON line of them all. Exits 1 if a kernel differs
    from its plain version, a route leaves a direction off unit by more
    than UNIT_TOL, or c5's frame or a fit step is not finite (a package
    whose bounce is not the upstream's reflect fails the last two)."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import raytracer_tpu_torch
    from raytracer_tpu_torch.ops import _build

    root = str(Path(raytracer_tpu_torch.__file__).resolve().parents[1])
    smi = card_line()
    print(f"{smi} (package at {root})", flush=True)
    t0 = time.perf_counter()
    procs = ptxas_start(("trace_whole", "trace_whole_bwd", "trace_level", "trace_level_bwd"))
    names = ("trace_whole", "trace_whole_bwd", "ray_stats", "trace_level", "trace_level_bwd",
             "fold_shortlist")
    _build.build(list(names))
    print(f"build: {', '.join(names)} {time.perf_counter() - t0:.1f} s", flush=True)
    result = {"root": root, "card": smi, "ptxas": [
        {k: row.get(k) for k in ("kernel", "registers", "spill_stores", "spill_loads", "stack")}
        for row in ptxas_finish(procs)]}
    print(f"bounce ptxas: {json.dumps(result['ptxas'])}", flush=True)
    # Each phase runs whatever the one before it found; one that raises (the
    # old bounce's overflow reaches a check as NaN) is a failed check.
    for key, fn in (("routes", bounce_routes), ("c5_frame", c5_frame), ("c5_fit", c5_fit),
                    ("times", c5_kernel_times)):
        t0 = time.perf_counter()
        try:
            result[key] = fn("cuda")
        except Exception as e:  # reported, and fails the run below
            result[key] = {"error": f"{type(e).__name__}: {e}"}
        print(f"bounce {key} ({time.perf_counter() - t0:.1f} s): {json.dumps(result[key])}",
              flush=True)
    print(json.dumps({"bounce": result}), flush=True)
    failed = [key for key in ("routes", "c5_frame", "c5_fit", "times") if "error" in result[key]]
    if "error" not in result["routes"]:
        failed += [k for k in ("whole", "chain", "loop") if not result["routes"][k]["ok"]]
    frame = result["c5_frame"]
    if "error" not in frame and (frame["nonfinite"] or not frame["pixels_finite"]):
        failed.append("c5_frame")
    if "error" not in result["c5_fit"]:
        failed += [f"c5_fit {s}" for s in map(str, F1_SEEDS) if not result["c5_fit"][s]["finite"]]
    if failed:
        print(f"chip_smoke: --bounce-only: failed: {failed}", file=sys.stderr)
        return 1
    return 0


def dist_only() -> int:
    """``--dist-only``: the card's line, the build, the distribution phase."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from raytracer_tpu_torch.ops import _build

    smi = card_line()
    print(smi, flush=True)
    _build.build(["trace_whole", "trace_whole_bwd", "ray_stats", "trace_level",
                  "trace_level_bwd", "soft_level", "soft_level_bwd", "fold_flat",
                  "fold_shortlist"])
    d = drive_dist("cuda:0")
    print_dist(d, smi)
    failed = dist_failures(d)
    if failed:
        print(f"chip_smoke: --dist-only: failed: {'; '.join(failed)}", file=sys.stderr)
        return 1
    return 0


# ---------------------------------------------------------------------------
# The soft diagnosis: what ptxas made of the soft kernels, how many blocks
# of each fit on an SM, and per level at 1920x1080 their times and how far
# lanes, warps and blocks reach into the sphere chunks
# ---------------------------------------------------------------------------

# The soft scenes timed level by level at 1920x1080, depth 1: c4 and the
# large soft fits' scenes (bench.py:207-220).
SOFT_LEVEL_SCENES = (("c4_grid64", 64), ("grid1024", 1024), ("grid2048", 2048))
# The soft fit steps timed at 1920x1080, depth 1.
SOFT_FIT_SIZES = (64, 1024, 2048, 4096)
_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_PTXAS_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads")
_PTXAS_USED = re.compile(r"Used (\d+) registers")
_PTXAS_SMEM = re.compile(r"(\d+) bytes smem")


def ptxas_start(names=("soft_level", "soft_level_bwd")) -> dict:
    """One ``nvcc -cubin -Xptxas -v`` per source of the imported package's
    csrc/, with its build flags, all started together: ``{name: (cubin,
    process)}``."""
    from raytracer_tpu_torch.ops import _build

    out = Path(tempfile.mkdtemp(prefix="ptxas_"))
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    procs = {}
    for name in names:
        cubin = out / f"{name}.cubin"
        cmd = [_build._nvcc(), *flags, "-cubin", "-Xptxas", "-v", "-o", str(cubin),
               str(_build.CSRC / f"{name}.cu")]
        procs[name] = (cubin, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True))
    return procs


def kernel_label(mangled: str) -> str:
    """``name<true,false>`` or ``name<2>`` of a mangled kernel in a
    namespace (``name`` without template arguments)."""
    m = re.match(r"_ZN(\d+)", mangled)
    rest = mangled[m.end() + int(m.group(1)):] if m else mangled
    m = re.match(r"(\d+)", rest)
    if not m:
        return mangled
    n = int(m.group(1))
    name, args = rest[m.end():m.end() + n], rest[m.end() + n:]
    flags = re.match(r"I((?:L[bi]\d+E)+)E", args)
    if not flags:
        return name
    vals = re.findall(r"L([bi])(\d+)E", flags.group(1))
    return f"{name}<{','.join(v if t == 'i' else ('true' if v == '1' else 'false') for t, v in vals)}>"


def ptxas_finish(procs: dict) -> list:
    """Each kernel entry of the started builds: its registers, spill stores
    and loads, stack frame and static shared memory (``ptxas -v``), with
    its cubin and mangled name. Raises if a build failed."""
    rows = []
    for name, (cubin, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"ptxas report of {name} failed:\n{log}")
        cur = None
        for line in log.splitlines():
            m = _PTXAS_ENTRY.search(line)
            if m:
                cur = dict(source=name, mangled=m.group(1), kernel=kernel_label(m.group(1)),
                           cubin=str(cubin))
                rows.append(cur)
            elif cur is not None and (m := _PTXAS_FRAME.search(line)):
                cur.update(stack=int(m[1]), spill_stores=int(m[2]), spill_loads=int(m[3]))
            elif cur is not None and (m := _PTXAS_USED.search(line)):
                s = _PTXAS_SMEM.search(line)
                cur.update(registers=int(m[1]), static_smem=int(s[1]) if s else 0)
    return rows


def occupancy(row: dict, block: int, smem: int) -> int:
    """Blocks of ``block`` threads and ``smem`` dynamic shared bytes of the
    kernel of ``row`` that fit on one SM
    (cuOccupancyMaxActiveBlocksPerMultiprocessor on its cubin); 0 where the
    kernel cannot have that much shared memory."""
    torch.zeros(1, device="cuda")  # the primary context, current on this thread
    lib = ctypes.CDLL("libcuda.so.1")
    mod, fn, n = ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_int(0)
    if lib.cuModuleLoad(ctypes.byref(mod), row["cubin"].encode()):
        raise RuntimeError(f"cuModuleLoad {row['cubin']} failed")
    try:
        if lib.cuModuleGetFunction(ctypes.byref(fn), mod, row["mangled"].encode()):
            raise RuntimeError(f"cuModuleGetFunction {row['mangled']} failed")
        if smem > 48 * 1024 and lib.cuFuncSetAttribute(fn, 8, ctypes.c_int(smem)):
            return 0  # 8: CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES
        if lib.cuOccupancyMaxActiveBlocksPerMultiprocessor(
                ctypes.byref(n), fn, ctypes.c_int(block), ctypes.c_size_t(smem)):
            return 0
        return n.value
    finally:
        lib.cuModuleUnload(mod)


def soft_smem(tables) -> dict:
    """Dynamic shared bytes of each soft kernel for ``tables``: the launch
    plan's where the package has one, else the whole-table layout's (the
    kernels before the sphere ring, which ``--soft-compare`` runs as the
    parent of the ring's change)."""
    from raytracer_tpu_torch.ops import cuda_soft

    plan = getattr(cuda_soft, "soft_launch_plan", None)
    if plan is not None:
        p = plan(tables.counts)
        return {"soft_level": p["smem"], "soft_level_bwd": p["smem_bwd"]}
    c = tables.counts
    n_lt = 6 * (c["n_pt"] + c["n_sun"]) + 2
    fwd = tables.smem_bytes
    bwd = fwd + 4 * (tables.packed.numel() - 12 * c["n_s_pad"] + n_lt * cuda_soft._BLOCK)
    return {"soft_level": fwd, "soft_level_bwd": bwd}


def _srecip_t(c: torch.Tensor) -> torch.Tensor:
    return torch.where(c.abs() > 1e-12, 1.0 / c, torch.where(c >= 0.0, 1e30, -1e30))


def group_cull(gates, o, d, tau, group: int = 32) -> torch.Tensor:
    """[n_groups, n_chunks]: whether the kernels' conservative test
    (soft_common.cuh's ``bounds_reach``) passes chunk c for the group of
    ``group`` consecutive lanes (flat planes in launch order; 32: a warp):
    the box gate's slab test over the box of the group's origins and
    reciprocal directions (float32 interval arithmetic, so it never rejects
    a chunk whose exact gate a lane passes). Its passes per warp, printed
    as ``warp_cull_pass``, say how much of a warp's gating the cull saves
    (PERF.md)."""
    n = o[0].numel()
    pad = -n % group

    def grouped(x):
        x = x.reshape(-1)
        if pad:
            x = torch.cat([x, x[-1:].expand(pad)])
        return x.view(-1, group)

    tau_eff = max(float(tau), 1e-6)
    tn_lo = tf_hi = None
    for k, x in enumerate("xyz"):
        og, ig = grouped(o[k]), grouped(_srecip_t(d[k]))
        olo, ohi = og.amin(1)[:, None], og.amax(1)[:, None]
        ilo, ihi = ig.amin(1)[:, None], ig.amax(1)[:, None]
        lo_k = hi_k = None
        for row in (6 + k, 9 + k):
            g = gates[row][None, :]
            a, b = g - ohi, g - olo
            corners = torch.stack([a * ilo, a * ihi, b * ilo, b * ihi])
            c_lo, c_hi = corners.amin(0), corners.amax(0)
            lo_k = c_lo if lo_k is None else torch.minimum(lo_k, c_lo)
            hi_k = c_hi if hi_k is None else torch.maximum(hi_k, c_hi)
        tn_lo = lo_k if tn_lo is None else torch.maximum(tn_lo, lo_k)
        tf_hi = hi_k if tf_hi is None else torch.minimum(tf_hi, hi_k)
    return ~(tn_lo > tf_hi) & ~(tf_hi <= -128.0 * tau_eff) & (gates[4][None, :] >= 0.0)


def reach_stats(tables, gates, o, d, order=None) -> dict:
    """Chunk reach of one level's lanes in launch order (``order``: flat
    lane indices, natural order if None): per lane (the exact gate,
    ``chunk_reachable``), the union over each warp (32 consecutive lanes)
    and each block (256), their ratios to the lane reach, and with the box
    gate the chunks a warp's conservative cull passes (``group_cull``).
    ``lane_pairs`` and ``warp_pairs``: the (lane, chunk) and (warp, chunk)
    pairs, which ``soft_level_bwd`` counts as ``soft_bwd.lane_chunks`` and
    ``soft_bwd.warp_chunks`` while a request is recorded."""
    from raytracer_tpu_torch.core.v3 import V3
    from raytracer_tpu_torch.ops import cuda_soft

    c = tables.counts
    o = [x.reshape(-1) for x in o]
    d = [x.reshape(-1) for x in d]
    if order is not None:
        o, d = [x[order] for x in o], [x[order] for x in d]
    n = o[0].numel()
    pad = -n % 256
    lane = warp = block = 0
    for k in range(c["n_chunks"]):
        m = cuda_soft.chunk_reachable(gates, c["gate"], k, V3(*o), V3(*d), SOFT_TAU)
        lane += int(m.sum())
        m = torch.cat([m, m.new_zeros(pad)]) if pad else m
        warp += int(m.view(-1, 32).any(1).sum())
        block += int(m.view(-1, 256).any(1).sum())
    n_w, n_b = (n + pad) // 32, (n + pad) // 256
    r = dict(lane=lane / n, warp=warp / n_w, block=block / n_b, lane_pairs=lane, warp_pairs=warp)
    r["warp_ratio"] = r["warp"] / max(r["lane"], 1e-30)
    r["block_ratio"] = r["block"] / max(r["lane"], 1e-30)
    if c["gate"] == 0:
        r["warp_cull"] = float(group_cull(gates, o, d, SOFT_TAU).sum()) / n_w
    return r


def soft_level_diagnosis(n_spheres: int, device, width: int = 1920, height: int = 1080,
                         reach: bool = True) -> dict:
    """Both soft kernels level by level on grid-``n_spheres`` at
    ``width`` x ``height``, depth 1, as the fit runs them (the forward with
    its residuals, each level in ``soft_levels``' lane order, the backward
    from a seeded image cotangent): each launch's time (CUDA events), and
    with ``reach`` each level's reach (``reach_stats``, in launch order)
    and share of lanes with throughput 0."""
    from raytracer_tpu_torch.core.v3 import V3
    from raytracer_tpu_torch.ops import cuda_soft

    scene = make_scene(("grid_sphere_scene", (n_spheres,)), device)
    o, d, w = frame_rays(width, height, device)
    with torch.no_grad():
        tables = cuda_soft.soft_tables(scene, SOFT_TAU, SOFT_TAU_Z)
    gates = cuda_soft.soft_gate_tables(scene, SOFT_TAU)
    # The package's lane-order rule (none before the ring: --soft-compare's parent).
    ordered = getattr(cuda_soft, "_orders_level", None)
    acc = V3(*(torch.zeros_like(w) for _ in range(3)))
    r = dict(n_s=n_spheres, fwd_ms=[], bwd_ms=[], reach=[], dead=[], bound_ms=[],
             bwd_bound_ms=[])
    levels = []
    with torch.no_grad():
        for k in range(2):
            last = k == 1
            kw = {}
            if ordered is not None and ordered(tables.counts, k):
                kw["order"] = cuda_soft.soft_lane_order(o, d)
            r["fwd_ms"].append(event_ms(lambda: cuda_soft.soft_level(
                tables, gates, o, d, w, acc, last, True, **kw), iters=5, warmup=1))
            out = cuda_soft.soft_level(tables, gates, o, d, w, acc, last, True, **kw)
            if reach:
                r["reach"].append(reach_stats(tables, gates, o, d, kw.get("order")))
                reached, n = r["reach"][-1]["lane"] * w.numel(), w.numel()
                n_carry = 5 if last else 15
                r["bound_ms"].append(soft_bound(soft_level_ops(tables.counts, reached, n, last),
                                                20, n)[0])
                r["bwd_bound_ms"].append(soft_bound(
                    soft_level_bwd_ops(tables.counts, reached, n, last),
                    7 + 1 + n_carry + 3 + (0 if last else 7) + 7, n)[0])
            r["dead"].append(float((w == 0).float().mean()))
            levels.append((o, d, w, out[4], kw))
            acc, w, o, d = out[0], out[1], out[2], out[3]
    gen = torch.Generator(device=device).manual_seed(0)
    ct = V3(*(torch.randn(w.shape, generator=gen, device=device) for _ in range(3)))
    sums = torch.zeros(tables.packed.shape, dtype=torch.float64, device=device)
    ct_next = None
    for k in (1, 0):
        o, d, w, res, kw = levels[k]
        r["bwd_ms"].append(event_ms(lambda: cuda_soft.soft_level_bwd(
            tables, gates, o, d, w, res, ct, ct_next, k == 1, sums, **kw), iters=5, warmup=1))
        ct_next = cuda_soft.soft_level_bwd(tables, gates, o, d, w, res, ct, ct_next, k == 1,
                                           sums, **kw)
    r["bwd_ms"].reverse()
    r["smem"] = soft_smem(tables)
    return r


def soft_diagnosis(device, procs=None) -> dict:
    """The ``soft diagnosis`` phase: ``ptxas -v`` of every instantiation
    of both soft kernels (``procs``: the builds ``ptxas_start`` started, or
    started here), their blocks per SM at each scene's shared memory, then
    ``soft_level_diagnosis`` of each of SOFT_LEVEL_SCENES."""
    from raytracer_tpu_torch.ops import cuda_soft

    procs = procs or ptxas_start()
    scenes_out = {name: soft_level_diagnosis(n, device) for name, n in SOFT_LEVEL_SCENES}
    ptx = ptxas_finish(procs)
    for row in ptx:
        row["blocks_per_sm"] = {name: occupancy(row, cuda_soft._BLOCK, s["smem"][row["source"]])
                                for name, s in scenes_out.items()}
    return dict(ptxas=ptx, scenes=scenes_out)


def soft_fit_steps(device, sizes=SOFT_FIT_SIZES, iters: int = 3) -> dict:
    """The soft fit step of grid-n at 1920x1080, depth 1, for each n of
    ``sizes`` (``benchmark_fit_step``, median of ``iters``), with the launch
    counts of its ``iters`` + 1 steps. Where the package predates the sphere
    ring (``--soft-compare``'s parent), a step that raises (4096 spheres
    exceeded its shared memory) is recorded as its error; else it fails the
    run."""
    from raytracer_tpu_torch.models import scenes
    from raytracer_tpu_torch.ops import cuda_soft
    from raytracer_tpu_torch.utils.profiler import benchmark_fit_step

    before_ring = not hasattr(cuda_soft, "soft_launch_plan")

    camera = scenes.reference_demo_camera(device=device)
    out = {}
    for n in sizes:
        reset_launches()
        try:
            fit = benchmark_fit_step(scenes.grid_sphere_scene(n, device=device), camera,
                                     1920, 1080, depth=1, soft=True, iters=iters)
        except ValueError as exc:
            if not before_ring:
                raise
            out[n] = dict(error=f"{type(exc).__name__}: {exc}")
            continue
        torch.cuda.synchronize()
        out[n] = dict(step_ms=fit["step_ms"], step_ms_all=fit["step_ms_all"],
                      launches=read_launches())
    return out


def soft_plan_matches(device) -> bool:
    """Whether ``cuda_soft.soft_launch_plan``'s shared bytes equal the ones
    the kernels compute (their exported ``*_smem_bytes``) for the table of
    every SOFT_CASES scene."""
    from raytracer_tpu_torch.ops import _build, cuda_soft

    lib = _build.load("soft_level", cuda_soft._SIGNATURES["soft_level"])
    libb = _build.load("soft_level_bwd", cuda_soft._SIGNATURES["soft_level_bwd"])
    ok = True
    for _, spec, _, _ in SOFT_CASES:
        with torch.no_grad():
            c = cuda_soft.soft_tables(make_scene(spec, device), SOFT_TAU, SOFT_TAU_Z).counts
        n_small = sum(c[s] for k, s in cuda_soft._PACK if not k.startswith("s_"))
        n_lt = 6 * (c["n_pt"] + c["n_sun"]) + 2
        p = cuda_soft.soft_launch_plan(c)
        ok &= (lib.soft_level_smem_bytes(n_small) == p["smem"]
               and libb.soft_level_bwd_smem_bytes(n_small, n_lt) == p["smem_bwd"])
    return ok


def print_soft_diagnosis(diag: dict):
    nan = float("nan")
    for row in diag["ptxas"]:
        print(f"soft diagnosis ptxas {row['kernel']}: registers={row['registers']} "
              f"spill_stores={row['spill_stores']} spill_loads={row['spill_loads']} "
              f"stack={row['stack']} static_smem={row['static_smem']} "
              f"blocks_per_sm={row['blocks_per_sm']}", flush=True)
    for name, s in diag["scenes"].items():
        for k in range(2):
            re_ = s["reach"][k] if s["reach"] else {}
            bounds = (f"bound_ms={s['bound_ms'][k]:.4f} bwd_bound_ms={s['bwd_bound_ms'][k]:.4f} "
                      if s["bound_ms"] else "")
            line = (f"soft diagnosis {name} 1920x1080 level {k}: "
                    f"soft_level_ms={s['fwd_ms'][k]:.4f} soft_level_bwd_ms={s['bwd_ms'][k]:.4f} "
                    + bounds +
                    f"lane_reach={re_.get('lane', nan):.3f} warp_union={re_.get('warp', nan):.3f} "
                    f"ratio={re_.get('warp_ratio', nan):.3f} "
                    f"block_union={re_.get('block', nan):.3f} "
                    f"block_ratio={re_.get('block_ratio', nan):.3f} "
                    f"warp_cull_pass={re_.get('warp_cull', nan):.3f} "
                    f"dead_share={s['dead'][k]:.4f} smem={s['smem']}")
            print(line, flush=True)


# ---------------------------------------------------------------------------
# The closest-hit kernels (fold_flat, fold_shortlist, fold_shortlist_hit)
# ---------------------------------------------------------------------------


def same_mask(a, b) -> torch.Tensor:
    """Where two planes agree bit for bit, NaN where NaN (-0.0 equals 0.0)."""
    return (a == b) | (torch.isnan(a) & torch.isnan(b))


def same_planes(a, b) -> bool:
    return bool(same_mask(a, b).all())


def max_err(a, b) -> float:
    """The largest |a - b| of two planes (NaN where both are NaN counts 0)."""
    if not a.numel():
        return 0.0
    return float((a.double() - b.double()).abs().nan_to_num(0.0, posinf=0.0).max())


def fold_ops(tables, listed, idx: np.ndarray, alive: np.ndarray, used: np.ndarray,
             kind: str) -> float:
    """Float32 operations of one closest-hit kernel on this run's data,
    reckoned from its source as ``trace_level_ops`` is (``fold_flat``'s:
    ``flat_ops``). ``"shortlist"`` and ``"record"``
    (csrc/fold_shortlist.cu): per alive lane the ray terms (19), walls and
    boxes; per used lane the slab clip (25) and the gate of every chunk of
    its tile's list; the spheres of one chunk where the winner is a sphere
    (a lower bound: a lane may fold more chunks than its winner's); with
    ``"record"`` the winner's record (sphere 38, wall 22, box 39)."""
    c = tables.counts
    n_s, n_w, n_b = c["n_s"], c["n_w"], c["n_b"]
    gate = 26 if c["gate"] == 0 else 24
    ops = float((19 + 39 * n_w + 25 * n_b) * alive.sum())
    if n_s:
        ops += float((25 * used + gate * listed * used).sum())
        ops += 22.0 * min(c["unroll"], n_s) * (alive & (idx >= 0) & (idx < n_s)).sum()
    if kind == "record":
        for rec, lo, hi in ((38, 0, n_s), (22, n_s, n_s + n_w),
                            (39, n_s + n_w, n_s + n_w + n_b)):
            ops += float(rec * (alive & (idx >= lo) & (idx < hi)).sum())
    return ops


def flat_ops(tables, o, d) -> tuple[float, dict]:
    """Float32 operations that the brute-force fold (csrc/fold_flat.cu)
    needs on this run's rays (any shape; the flat fold has no alive mask):
    per distinct origin (bit for bit) its |o|^2 (5) and each sphere's
    origin term |o|^2 - 2 o.c + |c|^2 - r^2 (8), which every ray from that
    origin shares (a camera's rays have one origin, bounce rays one each);
    per ray d.o (5), the three safe reciprocals (9) where the scene has
    boxes, every wall (39) and box (25); per ray-sphere test d.c, b_half,
    disc (8) and the guard's two compares; and only per test that meets its
    sphere ahead (disc >= 0 and b_half < 0, counted here on the rays'
    device) the root: sqrtf, its subtraction and two compares (4). Returns
    the count and its parts."""
    c, cols = tables.counts, tables.cols
    n_s, n_w, n_b = c["n_s"], c["n_w"], c["n_b"]
    ox, oy, oz, dx, dy, dz = (x.reshape(-1) for x in (*o, *d))
    n = dx.numel()
    bits = torch.stack([x.view(torch.int32) for x in (ox, oy, oz)], dim=1)
    origins = int(torch.unique(bits, dim=0).shape[0]) if n else 0
    roots = 0
    if n_s and n:
        oo = ox * ox + oy * oy + oz * oz
        do = dx * ox + dy * oy + dz * oz
        step = max(1, (1 << 26) // n)  # spheres a pass: ~64 M tests
        for s0 in range(0, n_s, step):
            sl = slice(s0, s0 + step)
            cx, cy, cz, cr2 = (cols[k][sl].view(-1, 1) for k in ("cx", "cy", "cz", "cr2"))
            b_half = do - (dx * cx + dy * cy + dz * cz)
            disc = b_half * b_half - (oo - 2.0 * (ox * cx + oy * cy + oz * cz) + cr2)
            roots += int(((disc >= 0.0) & (b_half < 0.0)).sum())
    ops = ((5 + 8 * n_s) * origins + (5 + (9 if n_b else 0) + 39 * n_w + 25 * n_b) * n
           + 10 * n * n_s + 4 * roots)
    return float(ops), dict(origins=origins, tests=n * n_s, roots=roots)


def hit_inputs(tables, o, d, w):
    """The rays' shortlists (``cuda_hit.shortlists``: a ``ray_stats``
    launch and phase A), and each lane's list length."""
    from raytracer_tpu_torch.ops import cuda_hit, cuda_level

    sl = cuda_hit.shortlists(tables, o, d, w)
    if sl is None:
        return None, np.full(tuple(w.shape), tables.counts["n_c"])
    (tr, tc), _, tw = cuda_level.tile_grid(w.shape)
    h, wd = w.shape
    tid = (torch.arange(h, device=w.device)[:, None] // tr * tw
           + torch.arange(wd, device=w.device)[None, :] // tc)
    return sl, sl[1].clamp_min(0)[tid].cpu().numpy()


def check_hit_rays(tables, o, d, w) -> dict:
    """The three closest-hit kernels against their plain versions on one
    set of ``[H, W]`` rays with their alive plane ``w``, on the same
    shortlists: ``fold_flat``, ``fold_shortlist`` and ``fold_shortlist_hit``
    bit for bit (every plane; NaN where NaN). Then the kernels against each
    other: the record's index is the fold's, and the brute-force fold
    (ungated) against the gated one on the alive lanes, with the lanes where
    they differ counted among all and among those whose direction is not
    unit (| |d| - 1 | > 1e-6), where a chunk's gate may drop a hit."""
    from raytracer_tpu_torch.ops import cuda_hit

    sl, _ = hit_inputs(tables, o, d, w)
    k10, p10 = cuda_hit.fold_flat(tables, o, d), cuda_hit.fold_flat_reference(tables, o, d)
    k9 = cuda_hit.fold_shortlist(tables, sl, o, d, w)
    p9 = cuda_hit.fold_shortlist_reference(tables, sl, o, d, w)
    k8 = cuda_hit.fold_shortlist_hit(tables, sl, o, d, w)
    p8 = cuda_hit.fold_shortlist_hit_reference(tables, sl, o, d, w)
    alive = w > 0
    norm = torch.sqrt(d.x.double() ** 2 + d.y.double() ** 2 + d.z.double() ** 2)
    non_unit = (norm - 1.0).abs() > 1e-6
    differ = alive & ((k10[1] != k9[1]) | ~same_mask(k10[0], k9[0]))
    out = dict(
        alive=int(alive.sum()), hits=int((alive & (k9[1] >= 0)).sum()),
        flat_same=same_planes(k10[0], p10[0]) and torch.equal(k10[1], p10[1]),
        shortlist_same=same_planes(k9[0], p9[0]) and torch.equal(k9[1], p9[1]),
        record_same=(torch.equal(k8[1], p8[1])
                     and all(same_planes(a, b) for a, b in zip(k8[:1] + k8[2:], p8[:1] + p8[2:]))),
        record_index_is_fold=torch.equal(k8[1], k9[1]),
        dead_miss=bool(((k9[1][~alive] == -1) & (k9[0][~alive] == 1e30)).all()
                       and (k8[1][~alive] == -1).all() and (k8[7][~alive] == 1.0).all()),
        flat_vs_shortlist_differ=int(differ.sum()),
        flat_vs_shortlist_differ_unit=int((differ & ~non_unit).sum()),
        non_unit_alive=int((alive & non_unit).sum()),
        flat_err=max_err(k10[0], p10[0]), shortlist_err=max_err(k9[0], p9[0]),
        record_err=max(max_err(a, b) for a, b in zip(k8[:1] + k8[2:], p8[:1] + p8[2:])),
    )
    out["ok"] = (out["flat_same"] and out["shortlist_same"] and out["record_same"]
                 and out["record_index_is_fold"] and out["dead_miss"]
                 and out["flat_vs_shortlist_differ_unit"] == 0)
    return out


def check_hit(case, device) -> dict:
    """The closest-hit kernels on one workload (``check_hit_rays``): the
    frame's primary rays, its level-1 bounce rays with their alive mask
    (from the per-level chain's residuals), and, on the first ray set, an
    all-dead mask."""
    from raytracer_tpu_torch.core.v3 import V3
    from raytracer_tpu_torch.ops import cuda_fold, cuda_level

    name, spec, width, height = case
    tables = cuda_fold.fused_tables(make_scene(spec, device))
    o, d, w = frame_rays(width, height, device)
    _, _, _, res = cuda_level.trace_levels(tables, o, d, w, 1, emit_res=True)
    r = res[0]
    out = dict(name=name, n_prim=sum(tables.counts[k] for k in ("n_s", "n_w", "n_b")),
               n_c=tables.counts["n_c"],
               primary=check_hit_rays(tables, o, d, w),
               bounce=check_hit_rays(tables, V3(*r[:3]), V3(*r[3:6]), r[6].contiguous()))
    dead = check_hit_rays(tables, o, d, torch.zeros_like(w))
    out["all_dead_ok"] = dead["ok"] and dead["hits"] == 0
    out["ok"] = out["primary"]["ok"] and out["bounce"]["ok"] and out["all_dead_ok"]
    for key in ("flat_err", "shortlist_err", "record_err"):
        out[key] = max(out["primary"][key], out["bounce"][key])
    return out


def flat_canary(device, width: int = 1920, height: int = 1080, depth: int = 3):
    """The ungated fold against the gated one on grid-1024's bounce rays at
    full size (kernels only): for each bounce level of the per-level chain,
    the alive lanes, those whose direction is not unit (| |d| - 1 | >
    1e-6, after grazing bounces), and the lanes where ``fold_flat`` and
    ``fold_shortlist`` differ, in all and at unit directions (where the
    gates are exact, so none may differ). Returns the rows and the ``[H,
    W]`` mask of lanes that differ at some level."""
    from raytracer_tpu_torch.core.v3 import V3
    from raytracer_tpu_torch.ops import cuda_fold, cuda_hit, cuda_level

    tables = cuda_fold.fused_tables(make_scene(("grid_sphere_scene", (1024,)), device))
    o, d, w = frame_rays(width, height, device)
    _, _, _, res = cuda_level.trace_levels(tables, o, d, w, depth, emit_res=True)
    rows, mask = [], torch.zeros((height, width), dtype=torch.bool, device=device)
    for k in range(depth):
        r = res[k]
        lo, ld, lw = V3(*r[:3]), V3(*r[3:6]), r[6].contiguous()
        t10, i10 = cuda_hit.fold_flat(tables, lo, ld)
        t9, i9 = cuda_hit.fold_shortlist(tables, cuda_hit.shortlists(tables, lo, ld, lw), lo, ld, lw)
        alive = lw > 0
        norm = torch.sqrt(ld.x.double() ** 2 + ld.y.double() ** 2 + ld.z.double() ** 2)
        non_unit = alive & ((norm - 1.0).abs() > 1e-6)
        differ = alive & ((i10 != i9) | ~same_mask(t10, t9))
        mask |= differ
        rows.append(dict(level=k + 1, alive=int(alive.sum()), non_unit=int(non_unit.sum()),
                         differ=int(differ.sum()), differ_unit=int((differ & ~non_unit).sum())))
    return rows, mask


def hit_kernel_times(tables, o, d, w, plain: bool = True, flat: bool = True) -> dict:
    """Each closest-hit kernel's device time (``event_ms``) on one set of
    ``[H, W]`` rays with their alive plane ``w``, its plain version's (with
    ``plain``), and its bound on this run's data: the bytes (each input
    plane and the shortlists read once, each output plane written once) at
    3.35 TB/s against ``fold_ops`` (``fold_flat``: ``flat_ops``) at 67
    TFLOP/s. Each kernel's output is held against its plain version's on
    the same inputs: ``same`` when
    every plane agrees bit for bit (NaN where NaN), and ``max_abs_err``.
    ``fold_flat`` only with ``flat``."""
    from raytracer_tpu_torch.ops import cuda_hit

    sl, listed = hit_inputs(tables, o, d, w)
    t9, i9 = cuda_hit.fold_shortlist(tables, sl, o, d, w)
    n = w.numel()
    alive = (w > 0).cpu().numpy()
    used = used_lanes(tables, o, d, w).cpu().numpy()
    idx = i9.cpu().numpy()
    sl_bytes = 4 * (int(sl[0].shape[0]) + int(sl[1].clamp_min(0).sum())) if sl is not None else 0
    calls = {
        "fold_flat": (lambda: cuda_hit.fold_flat(tables, o, d),
                      lambda: cuda_hit.fold_flat_reference(tables, o, d), 4 * 8 * n, "flat"),
        "fold_shortlist": (lambda: cuda_hit.fold_shortlist(tables, sl, o, d, w),
                           lambda: cuda_hit.fold_shortlist_reference(tables, sl, o, d, w),
                           4 * 9 * n + sl_bytes, "shortlist"),
        "fold_shortlist_hit": (lambda: cuda_hit.fold_shortlist_hit(tables, sl, o, d, w),
                               lambda: cuda_hit.fold_shortlist_hit_reference(tables, sl, o, d, w),
                               4 * 23 * n + sl_bytes, "record"),
    }
    if not flat:
        del calls["fold_flat"]
    out = {}
    for name, (kern, ref, nbytes, kind) in calls.items():
        ops = (flat_ops(tables, o, d)[0] if kind == "flat"
               else fold_ops(tables, listed, idx, alive, used, kind))
        got, want = kern(), ref()
        out[name] = dict(
            same=all(same_planes(a, b) for a, b in zip(got, want)),
            max_abs_err=max(max_err(a, b) for a, b in zip(got, want)),
            ms=event_ms(kern), plain_ms=event_ms(ref, iters=2, warmup=1) if plain else None,
            bound_ms=max(nbytes / PEAK_BYTES_S, ops / PEAK_F32_S) * 1e3,
            bound_by="bytes" if nbytes / PEAK_BYTES_S >= ops / PEAK_F32_S else "operations",
            mbytes=nbytes / 1e6, gflop=ops / 1e9, alive=int(alive.sum()),
            listed=float(listed.mean()) if tables.counts["n_c"] else 0.0,
        )
    return out


def loop_hit_rays(device, width: int = 1920, height: int = 1080, depth: int = 3):
    """The inputs of each ``closest_hit_soa`` call of ``drive_hit_loop``'s
    per-level loop (``render_tile`` with a ``closest_hit_fn``, on
    ``level_fit_start``'s grid-1024), one a level: the fused tables and per
    level the ``[H, W]`` planes ``(o, d, w)`` as ``hit_closest_shortlist``
    packs them (``cuda_hit._frame``; level 0 all alive)."""
    from raytracer_tpu_torch.ops import cuda_fold, cuda_hit
    from raytracer_tpu_torch.ops.trace import closest_hit_soa, render_tile

    start, camera, _ = level_fit_start(device, width, height)
    calls = []

    def hit_fn(sc, o, d, active=None):
        calls.append(cuda_hit._frame(o, d, active)[:3])
        return closest_hit_soa(sc, o, d, active=active)

    with torch.no_grad():
        render_tile(start, camera, width, height, depth=depth, closest_hit_fn=hit_fn)
    return cuda_fold.fused_tables(start), calls


def time_hit(spec, width: int, height: int, device, plain: bool = True,
             loop_depth: int | None = None) -> dict:
    """``hit_kernel_times`` on one frame's primary rays; with
    ``loop_depth``, under ``"loop_levels"`` also the shortlist kernels'
    times and bounds on each level of the per-level loop around
    ``closest_hit_soa`` at this frame size (``loop_hit_rays``: one launch a
    level)."""
    from raytracer_tpu_torch.ops import cuda_fold

    tables = cuda_fold.fused_tables(make_scene(spec, device))
    out = hit_kernel_times(tables, *frame_rays(width, height, device), plain)
    if loop_depth is not None:
        ltables, calls = loop_hit_rays(device, width, height, loop_depth)
        out["loop_levels"] = [hit_kernel_times(ltables, *c, plain=False, flat=False)
                              for c in calls]
    return out


def cutoff_sweep(device, width: int = 1920, height: int = 1080) -> list:
    """The record in one launch of ``fold_shortlist_hit`` against the fold
    kernel and ``hit_record`` in PyTorch (what ``closest_hit_soa`` runs
    below ``_MM_GATHER_MIN_PRIMS``), each as a caller sees it (CUDA events,
    nothing queued ahead, host work included, the shortlists' stats and
    phase A in both), at 3, 65 and 1025 primitives."""
    from raytracer_tpu_torch.models import scenes
    from raytracer_tpu_torch.ops import cuda_hit
    from raytracer_tpu_torch.ops.trace import hit_record, raygen_tile

    camera = scenes.reference_demo_camera(device=device)
    o, d = raygen_tile(camera, width, height)
    rows = []
    for spec in (("reference_demo_scene", ()), ("grid_sphere_scene", (64,)),
                 ("grid_sphere_scene", (1024,))):
        scene = make_scene(spec, device)
        record = lambda: cuda_hit.hit_closest_shortlist(scene, o, d)  # noqa: E731
        fold = lambda: hit_record(scene, o, d, *cuda_hit.fold_closest_shortlist(scene, o, d))  # noqa: E731
        record()
        fold()
        times = {"record_ms": [], "fold_hit_record_ms": []}
        for _ in range(3):  # in turns
            times["record_ms"].append(_calls_ms(record, 10))
            times["fold_hit_record_ms"].append(_calls_ms(fold, 10))
        rows.append(dict(n_prim=scene.num_primitives,
                         **{k: statistics.median(v) for k, v in times.items()},
                         rounds=times))
    return rows


def drive_depth(device, spec, width: int, height: int, reference: bool) -> dict:
    """``render_depth`` through the public entry point with every kernel's
    launch count set to 0 just before and read just after, no plain version
    on CUDA; the depth image's shape, inf share and finiteness, and with
    ``reference`` the same pass through the plain fold on the card
    (``closest_hit_soa`` with ``fold_closest``, the ``"jnp"`` selector): on
    camera rays (unit directions) the gates drop nothing, so the two must
    agree bit for bit."""
    from raytracer_tpu_torch import render_depth
    from raytracer_tpu_torch.models import scenes
    from raytracer_tpu_torch.ops import cuda_fold, cuda_level
    from raytracer_tpu_torch.ops.trace import closest_hit_soa, fold_closest, raygen_tile
    from raytracer_tpu_torch.render.integrator import _row_chunks

    scene = make_scene(spec, device)
    camera = scenes.reference_demo_camera(device=device)
    rows = _row_chunks(width, height, 0)
    expect = hit_expect(scene, -(-height // rows),
                        int(cuda_level.uses_shortlists(cuda_fold.fused_tables(scene))))
    with PlainOnCuda() as plain, torch.no_grad():
        reset_launches()
        dep = render_depth(scene, camera, width, height, device=device)
        torch.cuda.synchronize()
        launches = read_launches()
    inf = torch.isinf(dep)
    out = dict(launches=launches, expect=expect, plain_calls=plain.calls, shape=tuple(dep.shape),
               inf_share=float(inf.float().mean()),
               finite_ok=bool((torch.isfinite(dep) | (inf & (dep > 0))).all()),
               positive_ok=bool((dep[~inf] > 0).all()))
    if reference:
        o, d = raygen_tile(camera, width, height)
        with torch.no_grad():
            rec = closest_hit_soa(scene, o, d, fold_fn=fold_closest)
        ref = torch.where(rec.hit, rec.t, torch.inf)
        out["plain_equal"] = bool(torch.equal(dep, ref))
        out["plain_max_abs_err"] = max_err(dep[~inf], ref[~inf])
    out["ok"] = (launches == expect and plain.calls == 0 and out["finite_ok"]
                 and out["positive_ok"] and out.get("plain_equal", True)
                 and out["shape"] == (height, width))

    def frame():
        with torch.no_grad():
            render_depth(scene, camera, width, height, device=device)

    frame()
    times = [_calls_ms(frame, 1) for _ in range(10)]
    out.update(frame_ms=statistics.median(times), frame_ms_all=times)
    return out


def drive_fold_pass(device, spec, width: int, height: int) -> dict:
    """A direct caller of the ``"pallas"`` selector's fold
    (``resolve_fold_fn("pallas")``, ``cuda_hit.fold_closest_shortlist``):
    (t, index) of every camera ray, as a picking or visibility pass asks
    for them, with every kernel's launch count set to 0 just before and
    read just after: one ``fold_shortlist`` launch (and one ``ray_stats``
    where the scene has shortlists), no plain version on CUDA; the result
    against the plain fold (``fold_closest``) on the card, bit for bit (unit
    directions); the call's time."""
    from raytracer_tpu_torch.models import scenes
    from raytracer_tpu_torch.ops import cuda_fold, cuda_level
    from raytracer_tpu_torch.ops.trace import fold_closest, raygen_tile, resolve_fold_fn

    scene = make_scene(spec, device)
    o, d = raygen_tile(scenes.reference_demo_camera(device=device), width, height)
    fold = resolve_fold_fn("pallas")
    stats = int(cuda_level.uses_shortlists(cuda_fold.fused_tables(scene)))
    with PlainOnCuda() as plain, torch.no_grad():
        reset_launches()
        t, i = fold(scene, o, d)
        torch.cuda.synchronize()
        launches = read_launches()
    t_ref, i_ref = fold_closest(scene, o, d)
    out = dict(launches=launches, plain_calls=plain.calls, hits=int((i >= 0).sum()),
               plain_equal=torch.equal(i, i_ref) and torch.equal(t, t_ref))
    out["ok"] = (launches == launches_of(fold_shortlist=1, ray_stats=stats)
                 and plain.calls == 0 and out["plain_equal"])
    fold(scene, o, d)
    out["call_ms"] = statistics.median([_calls_ms(lambda: fold(scene, o, d), 1)
                                        for _ in range(10)])
    return out


def hit_expect(scene, n_calls: int, stats: int) -> dict:
    """The launch counts of ``n_calls`` ``closest_hit_soa`` calls with the
    default fold on ``scene``: the record kernel from
    ``_MM_GATHER_MIN_PRIMS`` primitives up, else the fold kernel; one
    ``ray_stats`` a call where the scene has shortlists (``stats``)."""
    from raytracer_tpu_torch.ops import trace

    kernel = ("fold_shortlist_hit" if scene.num_primitives >= trace._MM_GATHER_MIN_PRIMS
              else "fold_shortlist")
    return launches_of(**{kernel: n_calls}, ray_stats=stats * n_calls)


def drive_flat_render(device, spec=("sprint3_scene", ()), width: int = 1920,
                      height: int = 1080, depth: int = 3, canary=None) -> dict:
    """``render(fold="pallas_flat")`` through the public entry point: one
    ``fold_flat`` launch per level and no other kernel, no plain version on
    CUDA; its image against ``render()``'s (the whole-trace kernel or the
    per-level chain) on the same frame: with ``canary`` (``flat_canary``'s
    mask of lanes where the ungated and gated folds differ at some bounce
    level), the pixels that differ by more than 1e-5 must all lie in it;
    without, at most 1e-4 of the pixels may differ, none by more than 1e-5;
    both frame times (``benchmark_render``)."""
    from raytracer_tpu_torch import render
    from raytracer_tpu_torch.models import scenes
    from raytracer_tpu_torch.utils.profiler import benchmark_render

    scene = make_scene(spec, device)
    camera = scenes.reference_demo_camera(device=device)
    with PlainOnCuda() as plain, torch.no_grad():
        reset_launches()
        img = render(scene, camera, width, height, depth=depth, fold="pallas_flat", device=device)
        torch.cuda.synchronize()
        launches = read_launches()
    ref = render(scene, camera, width, height, depth=depth, device=device)
    near = (same_mask(img, ref) | ((img - ref).abs() <= 1e-5)).all(dim=-1)
    out = dict(launches=launches, plain_calls=plain.calls, image=image_stats(img),
               equal_frac=float(same_mask(img, ref).all(dim=-1).float().mean()),
               differ=int((~near).sum()),
               max_abs_err=float((img - ref).abs().nan_to_num(0.0).max()))
    ok = (launches == launches_of(fold_flat=depth + 1) and plain.calls == 0
          and out["image"]["nonfinite"] == 0 and out["image"]["range_ok"])
    if canary is None:
        ok &= out["equal_frac"] >= 0.9999 and out["differ"] == 0
    else:
        out["canary_lanes"] = int(canary.sum())
        out["differ_outside_canary"] = int((~near & ~canary).sum())
        ok &= out["differ_outside_canary"] == 0
    out["ok"] = ok
    for fold in ("pallas_flat", "auto"):
        out[f"frame_ms_{fold}"] = benchmark_render(scene, camera, width, height, depth=depth,
                                                   iters=20, fold=fold)["frame_ms"]
    return out


def drive_hit_loop(device, width: int = 1920, height: int = 1080, depth: int = 3) -> dict:
    """The per-level bounce loop around ``closest_hit_soa`` (``render_tile``
    with a ``closest_hit_fn``, the port's counterpart of the JAX
    ``trace_soa(closest_hit_fn=...)``) on grid-1024: the shortlist-hit
    kernel and one ``ray_stats`` per level, no other kernel, no plain
    version on CUDA. Its image against the default route's (the per-level
    trace kernels) on the same frame; then the gradient of the large-scene
    fit's loss (``level_fit_start``) with respect to the sphere centres and
    colours through ``_ShortlistHit`` (its backward: autograd of the record
    math) against the default route's (``_LevelTrace``, the backward
    kernel), within 1e-3 of each leaf's largest entry (the hand-derived
    adjoint and autograd round apart, and the gather's backward adds in a
    varying order); both frame times."""
    from raytracer_tpu_torch import default_params, merge_params, render
    from raytracer_tpu_torch.ops.tonemap import reinhard_tonemap
    from raytracer_tpu_torch.ops.trace import closest_hit_soa, render_tile

    def hit_fn(sc, o, d, active=None):
        return closest_hit_soa(sc, o, d, active=active)

    def loop_render(sc, camera):
        return reinhard_tonemap(render_tile(sc, camera, width, height, depth=depth,
                                            closest_hit_fn=hit_fn).stacked())

    start, camera, target = level_fit_start(device, width, height)
    with PlainOnCuda() as plain, torch.no_grad():
        reset_launches()
        img = loop_render(start, camera)
        torch.cuda.synchronize()
        launches = read_launches()
    expect = hit_expect(start, depth + 1, 1)
    ref = render(start, camera, width, height, depth=depth, device=device)
    equal = same_mask(img, ref).all(dim=-1)
    out = dict(launches=launches, expect=expect, plain_calls=plain.calls,
               image=image_stats(img), equal_frac=float(equal.float().mean()))

    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in default_params(start).items()}
    grads = {}
    for route in ("loop", "default"):
        sc = merge_params(start, params)
        reset_launches()
        img_g = (loop_render(sc, camera) if route == "loop"
                 else render(sc, camera, width, height, depth=depth, device=device))
        loss = torch.mean((img_g - target) ** 2)
        grads[route] = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        torch.cuda.synchronize()
        out[f"grad_launches_{route}"] = read_launches()
        out[f"loss_{route}"] = float(loss.detach())
    rel = {k: float((grads["loop"][k] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
           for k, g in grads["default"].items()}
    out.update(grad_rel_err=rel, grad_scale={k: float(g.abs().max())
                                             for k, g in grads["default"].items()},
               grad_finite=all(bool(torch.isfinite(g).all()) for g in grads["loop"].values()))
    out["ok"] = (launches == expect and plain.calls == 0 and out["equal_frac"] >= 0.999
                 and out["grad_launches_loop"] == expect and out["grad_finite"]
                 and all(v <= 1e-3 for v in rel.values()))

    def loop_frame():
        with torch.no_grad():
            loop_render(start, camera)

    def default_frame():
        with torch.no_grad():
            render(start, camera, width, height, depth=depth, device=device)

    for name, fn in (("loop", loop_frame), ("default", default_frame)):
        fn()
        out[f"frame_ms_{name}"] = statistics.median([_calls_ms(fn, 1) for _ in range(10)])
    return out


def print_hit(r: dict):
    def rays(x):
        return (f"ok={x['ok']} alive={x['alive']} hits={x['hits']} flat_same={x['flat_same']} "
                f"shortlist_same={x['shortlist_same']} record_same={x['record_same']} "
                f"record_index_is_fold={x['record_index_is_fold']} dead_miss={x['dead_miss']} "
                f"flat_vs_shortlist_differ={x['flat_vs_shortlist_differ']} "
                f"(at unit directions {x['flat_vs_shortlist_differ_unit']}; "
                f"non-unit alive lanes {x['non_unit_alive']})")

    print(f"closest-hit {r['name']} ({r['n_prim']} primitives, {r['n_c']} chunks): ok={r['ok']} "
          f"all_dead_ok={r['all_dead_ok']} primary: {rays(r['primary'])}; "
          f"bounce: {rays(r['bounce'])}", flush=True)


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


# ---------------------------------------------------------------------------
# The per-level diagnosis (trace_level, trace_level_bwd) and --level-only
# ---------------------------------------------------------------------------

# (name, spheres, width, height, depth): grid-1024 at 1080p d3 (the large
# render and fit path), c5 (grid-1024 at 4K d4, here one launch a level for
# the whole frame, where the render path runs 4 row chunks), and grid-2048
# at 1080p d3 (64 chunks, a 44 KB table).
LEVEL_DIAG_SCENES = (
    ("grid1024_1920x1080_d3", 1024, 1920, 1080, 3),
    ("c5_grid1024_3840x2160_d4", 1024, 3840, 2160, 4),
    ("grid2048_1920x1080_d3", 2048, 1920, 1080, 3),
)
# The warp's passing-lane counts below which the diagnosis reports the
# cooperative fold's share of a warp's chunks (33: every chunk).
PAIR_SWEEP = (4, 8, 12, 16, 33)


def level_smem(tables, stats: bool) -> int:
    """Dynamic shared bytes of a trace_level launch for ``tables``: the
    package's own plan where it has one, else the table without its
    materials, the shortlist and, with ``stats``, the stats scratch."""
    from raytracer_tpu_torch.ops import cuda_level

    plan = getattr(cuda_level, "level_smem_bytes", None)
    if plan is not None:
        return plan(tables, stats)
    c = tables.counts
    n_prim = c["n_s"] + c["n_w"] + c["n_b"]
    words = tables.packed.numel() - 8 * n_prim + c["n_c"]
    if stats:
        words += 32 * 10 + (c["n_c"] + 31) // 32
    return 4 * words


def level_bwd_smem(tables) -> int:
    """Dynamic shared bytes of a trace_level_bwd launch for ``tables``:
    the package's own plan where it has one, else the table without its
    materials and the light and sky row."""
    from raytracer_tpu_torch.ops import cuda_level

    plan = getattr(cuda_level, "level_bwd_smem_bytes", None)
    if plan is not None:
        return plan(tables)
    c = tables.counts
    n_prim = c["n_s"] + c["n_w"] + c["n_b"]
    return 4 * (tables.packed.numel() - 8 * n_prim + 6 * (c["n_pt"] + c["n_sun"]) + 10)


def level_reach(tables, shortlist, o, d, w, t_level, tile=None) -> dict:
    """One level's chunk reach in the kernel's lane order (``lane_slots``;
    the parent's layout is the same): per used lane (alive, meeting the
    slab) the listed chunks whose gate it passes with t1 = t_ex and with t1
    = min(t_ex, the level's t), and per warp with a used lane the union of
    each; the alive lanes of a warp that has one."""
    from raytracer_tpu_torch.ops import cuda_fold, cuda_level

    t, c = tables.cols, tables.counts
    (tr, tc), _, tw = cuda_level.tile_grid(w.shape, tile)
    h, wd = w.shape
    ys = torch.arange(h, device=w.device)[:, None]
    xs = torch.arange(wd, device=w.device)[None, :]
    tid = ys // tr * tw + xs // tc
    warp = tid * 8 + ((ys % tr) * tc + xs % tc) // 32
    n_warps = int(warp.max()) + 1
    iv = tuple(cuda_fold._srecip(x) for x in d)
    t0, t_ex, seg = cuda_fold._slab_segment(t, o, iv)
    used = (w > 0) & seg
    oo = o.x * o.x + o.y * o.y + o.z * o.z
    do = d.x * o.x + d.y * o.y + d.z * o.z
    t_fin = torch.minimum(t_ex, t_level)
    chunk_list, counts = shortlist
    lists, n_list = chunk_list.long()[tid], counts[tid]
    r = dict(lane_ex=0, lane_fin=0, warp_ex=0, warp_fin=0)
    for k in range(c["n_c"]):
        listed = used & (k < n_list)
        if not bool(listed.any()):
            break
        ch = lists[..., k]
        for key, t1 in (("ex", t_ex), ("fin", t_fin)):
            g = listed & cuda_fold._chunk_gate(t, c["gate"], ch, o, d, iv, oo, do, t0, t1)
            r["lane_" + key] += int(g.sum())
            r["warp_" + key] += int((torch.bincount(warp[g], minlength=n_warps) > 0).sum())
    n_used = int(used.sum())
    n_act = int((torch.bincount(warp[used], minlength=n_warps) > 0).sum())
    alive_w = torch.bincount(warp[w > 0], minlength=n_warps)
    out = dict(used=n_used, warps_used=n_act,
               alive_per_warp=float(alive_w[alive_w > 0].float().mean()) if bool((alive_w > 0).any()) else 0.0)
    for key in ("ex", "fin"):
        out[f"lane_reach_{key}"] = r["lane_" + key] / max(n_used, 1)
        out[f"warp_union_{key}"] = r["warp_" + key] / max(n_act, 1)
        out[f"warp_ratio_{key}"] = out[f"warp_union_{key}"] / max(out[f"lane_reach_{key}"], 1e-30)
    return out


def pair_shares(hist: list, two: bool) -> dict:
    """From the warp chunks' passing-lane histogram: for each K of
    PAIR_SWEEP, the share of warp chunks folded cooperatively and the warp
    steps they take (a lane a step; two for chunks of <= 16 spheres)."""
    total = max(sum(hist), 1)
    out = {}
    for k in PAIR_SWEEP:
        pair = sum(hist[j] for j in range(1, min(k, 33)))
        steps = sum(hist[j] * (-(-j // 2) if two else j) for j in range(1, min(k, 33)))
        out[k] = dict(pair_share=pair / total, pair_steps=steps,
                      lane_chunks=sum(hist[j] for j in range(min(k, 33), 33)))
    return out


def bwd_scatter_stats(tables, i_k: torch.Tensor, w: torch.Tensor) -> dict:
    """One backward level's attribute scatter in its lane order (32
    consecutive lanes of the flat planes a warp): the distinct winners a
    warp with a hit has, the warps with a wall or box winner, and the
    float64 atomics of the parent's design (14 per distinct winner of each
    warp, plus the light and sky row once per block of its grid of at most
    8 blocks an SM), of which those to wall and box rows."""
    c = tables.counts
    n_s, n_prim = c["n_s"], c["n_s"] + c["n_w"] + c["n_b"]
    n_ls = 6 * (c["n_pt"] + c["n_sun"]) + 10
    act = ((w > 0) & (i_k >= 0)).reshape(-1)
    lane = torch.arange(act.numel(), device=w.device)[act]
    key = i_k.reshape(-1)[act].long()
    warp = lane // 32
    pairs = torch.unique(warp * (n_prim + 1) + key)
    pw, pk = pairs // (n_prim + 1), pairs % (n_prim + 1)
    n_warps = int(torch.unique(warp).numel())
    wall_pairs = int((pk >= n_s).sum())
    blocks = min(-(-act.numel() // 256), 8 * torch.cuda.get_device_properties(0).multi_processor_count)
    return dict(warps_hit=n_warps, winners_per_warp=pairs.numel() / max(n_warps, 1),
                wall_box_warps=int(torch.unique(pw[pk >= n_s]).numel()),
                atomics_parent=14 * int(pairs.numel()) + n_ls * blocks,
                atomics_parent_walls=14 * wall_pairs,
                atomics_sphere_rows=14 * int((pk < n_s).sum()))


def level_diagnosis_scene(n_spheres: int, width: int, height: int, depth: int, device,
                          reach: bool = True) -> dict:
    """Both per-level kernels level by level on grid-``n_spheres``, as the
    chain runs them: per level the trace_level launch's time with its next
    stats and without them (``want_stats=False`` on the same inputs), the
    lanes alive and the listed chunks a tile; with ``reach`` also the reach
    (``level_reach``), and where the package has the plain mirrors the
    exact fold work by route (``pair_fold_reference``) and the next stats'
    warp cull (``warp_cull_reference``); then per level the backward's time
    on the cotangents its chain passes down and, with ``reach``, its scatter
    (``bwd_scatter_stats``)."""
    from raytracer_tpu_torch.core.v3 import V3
    from raytracer_tpu_torch.ops import cuda_fold, cuda_level

    scene = make_scene(("grid_sphere_scene", (n_spheres,)), device)
    tables = cuda_fold.fused_tables(scene)
    o, d, w = frame_rays(width, height, device)
    _, t_k, i_k, res = cuda_level.trace_levels(tables, o, d, w, depth, emit_res=True)
    levels = cuda_fold.Residuals(o, d, w, t_k, i_k, res)
    out = dict(n_c=tables.counts["n_c"], unroll=tables.counts["unroll"],
               smem=level_smem(tables, True), smem_last=level_smem(tables, False),
               stats_ms=event_ms(lambda: cuda_level.ray_stats(tables, o, d, w)), levels=[])
    stats = cuda_level.ray_stats(tables, o, d, w)
    pair_ref = getattr(cuda_level, "pair_fold_reference", None)
    cull_ref = getattr(cuda_level, "warp_cull_reference", None)
    k_min = getattr(cuda_level, "PAIR_MIN_LANES", None)
    zero = V3(*(torch.zeros_like(w) for _ in range(3)))
    for k in range(depth + 1):
        lo, ld, lw = levels.level(k)
        last = k == depth
        sl = cuda_level.phase_a(stats, tables)
        tt, ii = torch.empty_like(w), torch.empty(w.shape, dtype=torch.int32, device=device)
        nxt = None if last else [torch.empty_like(w) for _ in range(7)]
        acc = V3(*(torch.zeros_like(w) for _ in range(3)))

        def launch(want):
            return cuda_level.trace_level(tables, sl, lo, ld, lw, acc, tt, ii, nxt, last,
                                          None, want)

        row = dict(level=k, ms=event_ms(lambda: launch(not last)),
                   alive=int((lw > 0).sum()), listed=float(sl[1].clamp_min(0).float().mean()))
        if not last:
            row["ms_no_stats"] = event_ms(lambda: launch(False))
        if reach:
            row.update(level_reach(tables, sl, lo, ld, lw, t_k[k]))
        if reach and pair_ref is not None:
            work = pair_ref(tables, sl, lo, ld, lw, zero, last, k_min)[1]
            row["fold_work"] = work
            row["lane_reach_exact"] = work["lane_chunks"] / max(work["used"], 1)
            row["warp_union_exact"] = work["warp_chunks"] / max(work["warps"], 1)
            row["warp_ratio_exact"] = row["warp_union_exact"] / max(row["lane_reach_exact"], 1e-30)
            row["pair_shares"] = pair_shares(work["pass_hist"], tables.counts["unroll"] <= 16)
        stats = launch(not last)
        if reach and cull_ref is not None and not last:
            nw = res[k, 6]
            _, cull = cull_ref(tables, V3(*res[k, :3]), V3(*res[k, 3:6]), nw)
            used_w = cull.any(dim=1)
            row["next_cull_per_warp"] = float(cull[used_w].sum(dim=1).float().mean()) if bool(used_w.any()) else 0.0
        out["levels"].append(row)
    gen = torch.Generator().manual_seed(1234)
    ct = V3(*(torch.randn(w.shape, generator=gen).to(device) for _ in range(3)))
    attrs, ls = (a.detach() for a in cuda_fold.attribute_tables(scene))
    sums = (torch.zeros(attrs.shape, dtype=torch.float64, device=device),
            torch.zeros(ls.shape, dtype=torch.float64, device=device))
    cts = [None]
    for k in reversed(range(depth + 1)):
        lo, ld, lw = levels.level(k)
        cts.insert(0, cuda_level.trace_level_bwd(tables, attrs, ls, lo, ld, lw, t_k[k], i_k[k],
                                                 ct, cts[0], k == depth, sums))
    for k in range(depth + 1):
        lo, ld, lw = levels.level(k)
        cn = cts[k + 1]
        out["levels"][k]["bwd_ms"] = event_ms(
            lambda: cuda_level.trace_level_bwd(tables, attrs, ls, lo, ld, lw, t_k[k], i_k[k],
                                               ct, cn, k == depth, sums))
        if reach:
            out["levels"][k]["bwd"] = bwd_scatter_stats(tables, i_k[k], lw)
    out["fwd_ms"] = [r["ms"] for r in out["levels"]]
    out["bwd_ms_list"] = [r["bwd_ms"] for r in out["levels"]]
    return out


def compaction_variant(n_spheres: int, width: int, height: int, depth: int, device) -> dict:
    """Dead-lane compaction of the bounce levels, measured: for each level
    k >= 1 of grid-``n_spheres`` at ``width`` x ``height``, the chain's own
    work (``phase_a`` on the stats the previous launch wrote, then
    ``trace_level`` with the next stats) against the compacted level: the
    alive lanes gathered in order (``nonzero``, a host sync) into full rows
    of ``width`` lanes, ``ray_stats`` and ``phase_a`` over those tiles,
    ``trace_level`` on them, and t, index, accumulator and next rays
    scattered back. Both on the same inputs, as device time (``event_ms``,
    the host's wait in ``nonzero`` included), and the alive lanes whose
    selection differs (other tiles give other shortlist orders, which can
    change a lane with a non-unit direction: ROADMAP queue 3)."""
    from raytracer_tpu_torch.core.v3 import V3
    from raytracer_tpu_torch.ops import cuda_fold, cuda_level

    tables = cuda_fold.fused_tables(make_scene(("grid_sphere_scene", (n_spheres,)), device))
    o, d, w = frame_rays(width, height, device)
    _, t_k, i_k, res = cuda_level.trace_levels(tables, o, d, w, depth, emit_res=True)
    levels = cuda_fold.Residuals(o, d, w, t_k, i_k, res)
    out = dict(name=f"grid{n_spheres}_{width}x{height}_d{depth}", levels=[])
    stats = cuda_level.ray_stats(tables, o, d, w)
    for k in range(depth + 1):
        lo, ld, lw = levels.level(k)
        last = k == depth
        prev = stats
        tt, ii = torch.empty_like(w), torch.empty(w.shape, dtype=torch.int32, device=device)
        nxt = None if last else [torch.empty_like(w) for _ in range(7)]
        acc = V3(*(torch.zeros_like(w) for _ in range(3)))

        def chain():
            sl = cuda_level.phase_a(prev, tables)
            return cuda_level.trace_level(tables, sl, lo, ld, lw, acc, tt, ii, nxt, last, None,
                                          not last)

        stats = chain()
        if k == 0:
            continue
        planes = (*lo, *ld, lw)

        def compacted():
            idx = torch.nonzero(lw.reshape(-1) > 0).squeeze(1)
            rows = max(-(-idx.numel() // width), 1)
            packed = torch.zeros((7, rows * width), device=device)
            for j, x in enumerate(planes):
                packed[j, :idx.numel()] = x.reshape(-1)[idx]
            packed = packed.view(7, rows, width)
            po, pd, pw = V3(*packed[:3]), V3(*packed[3:6]), packed[6]
            pacc = V3(*(torch.zeros_like(pw) for _ in range(3)))
            pt = torch.empty_like(pw)
            pi = torch.empty(pw.shape, dtype=torch.int32, device=device)
            pn = None if last else [torch.empty_like(pw) for _ in range(7)]
            sl = cuda_level.phase_a(cuda_level.ray_stats(tables, po, pd, pw), tables)
            cuda_level.trace_level(tables, sl, po, pd, pw, pacc, pt, pi, pn, last, None, False)
            t_out = torch.full_like(w, float(cuda_level.MISS_T)).view(-1)
            i_out = torch.full(w.shape, -1, dtype=torch.int32, device=device).view(-1)
            t_out[idx] = pt.reshape(-1)[:idx.numel()]
            i_out[idx] = pi.reshape(-1)[:idx.numel()]
            for a, b in zip(acc, pacc):
                a.view(-1)[idx] = b.reshape(-1)[:idx.numel()]
            if pn is not None:
                for a, b in zip(nxt, pn):
                    a.view(-1)[idx] = b.reshape(-1)[:idx.numel()]
            return t_out.view(w.shape), i_out.view(w.shape)

        ct, ci = compacted()
        out["levels"].append(dict(
            level=k, alive=int((lw > 0).sum()), chain_ms=event_ms(chain),
            compacted_ms=event_ms(compacted),
            mismatches=int(((ci != i_k[k]) & (lw > 0)).sum())))
    out["chain_ms"] = sum(r["chain_ms"] for r in out["levels"])
    out["compacted_ms"] = sum(r["compacted_ms"] for r in out["levels"])
    return out


def level_diagnosis(device, procs=None) -> dict:
    """``ptxas -v`` of the per-level kernels (registers, spills), their
    blocks per SM at each diagnosed scene's shared bytes, and
    ``level_diagnosis_scene`` for each of LEVEL_DIAG_SCENES."""
    from raytracer_tpu_torch.ops import cuda_fold

    rows = ptxas_finish(procs or ptxas_start(("ray_stats", "trace_level", "trace_level_bwd")))
    out = {"ptxas": rows, "scenes": {}}
    for name, n, width, height, depth in LEVEL_DIAG_SCENES:
        out["scenes"][name] = level_diagnosis_scene(n, width, height, depth, device)
    for n in sorted({n for _, n, *_ in LEVEL_DIAG_SCENES}):
        tables = cuda_fold.fused_tables(make_scene(("grid_sphere_scene", (n,)), device))
        for row in rows:
            if row["source"] == "trace_level":
                stats = row["kernel"].endswith("<true>")
                row[f"blocks_per_sm_grid{n}"] = occupancy(row, 256, level_smem(tables, stats))
            elif row["source"] == "trace_level_bwd" and not row["kernel"].endswith("<false>"):
                row[f"blocks_per_sm_grid{n}"] = occupancy(row, 256, level_bwd_smem(tables))
    return out


def print_level_diagnosis(diag: dict):
    for row in diag["ptxas"]:
        occ = {k: v for k, v in row.items() if k.startswith("blocks_per_sm")}
        print(f"level diagnosis ptxas {row['kernel']}: registers={row.get('registers')} "
              f"spill_stores={row.get('spill_stores')} spill_loads={row.get('spill_loads')} "
              f"{occ}", flush=True)
    for name, sc in diag["scenes"].items():
        print(f"level diagnosis {name}: n_c={sc['n_c']} unroll={sc['unroll']} "
              f"smem={sc['smem']} ray_stats_ms={sc['stats_ms']:.4f}", flush=True)
        for r in sc["levels"]:
            exact = ""
            if "warp_union_exact" in r:
                exact = (f" exact: lane_reach={r['lane_reach_exact']:.3f} "
                         f"warp_union={r['warp_union_exact']:.3f} "
                         f"ratio={r['warp_ratio_exact']:.3f} pair_shares="
                         + str({k: round(v['pair_share'], 3) for k, v in r['pair_shares'].items()}))
            if "next_cull_per_warp" in r:
                exact += f" next_cull_per_warp={r['next_cull_per_warp']:.3f}"
            b = r["bwd"]
            print(f"  level {r['level']}: trace_level_ms={r['ms']:.4f} "
                  f"no_stats_ms={r.get('ms_no_stats', r['ms']):.4f} alive={r['alive']} "
                  f"listed={r['listed']:.2f} used={r['used']} "
                  f"lane_reach t_ex/final={r['lane_reach_ex']:.3f}/{r['lane_reach_fin']:.3f} "
                  f"warp_union={r['warp_union_ex']:.3f}/{r['warp_union_fin']:.3f} "
                  f"ratio={r['warp_ratio_ex']:.3f}/{r['warp_ratio_fin']:.3f} "
                  f"alive_per_warp={r['alive_per_warp']:.2f}{exact}; "
                  f"trace_level_bwd_ms={r['bwd_ms']:.4f} winners_per_warp="
                  f"{b['winners_per_warp']:.3f} wall_box_warps={b['wall_box_warps']} "
                  f"f64_atomics_parent={b['atomics_parent']} to_walls={b['atomics_parent_walls']}",
                  flush=True)


def shared_kernel_times(device) -> dict:
    """The kernels that share trace_common.cuh with the per-level kernels,
    each timed on its main frame (``event_ms``): trace_whole on sprint3
    and grid-64 at 1920x1080 d3, trace_whole_bwd on sprint3's residuals,
    and the closest-hit folds on sprint3 (fold_flat) and grid-1024
    (fold_shortlist, fold_shortlist_hit) at 1920x1080."""
    from raytracer_tpu_torch.core.v3 import V3
    from raytracer_tpu_torch.ops import cuda_fold

    out = {}
    for name, spec in (("sprint3", ("sprint3_scene", ())), ("grid64", ("grid_sphere_scene", (64,)))):
        scene = make_scene(spec, device)
        tables = cuda_fold.fused_tables(scene)
        o, d, w = frame_rays(1920, 1080, device)
        out[f"trace_whole_{name}"] = event_ms(lambda: cuda_fold.trace_whole(tables, o, d, w, 3))
        if name == "sprint3":
            _, t_w, i_w, res = cuda_fold.trace_whole(tables, o, d, w, 3, emit_res=True)
            lv = cuda_fold.Residuals(o, d, w, t_w, i_w, res)
            attrs, ls = (a.detach() for a in cuda_fold.attribute_tables(scene))
            gen = torch.Generator().manual_seed(7)
            ct = V3(*(torch.randn(w.shape, generator=gen).to(device) for _ in range(3)))
            out["trace_whole_bwd_sprint3"] = event_ms(
                lambda: cuda_fold.trace_whole_bwd(tables, attrs, ls, lv, ct, 3))
    out["fold_flat_sprint3"] = time_hit(("sprint3_scene", ()), 1920, 1080, device,
                                        plain=False)["fold_flat"]["ms"]
    g = time_hit(("grid_sphere_scene", (1024,)), 1920, 1080, device, plain=False)
    out["fold_shortlist_grid1024"] = g["fold_shortlist"]["ms"]
    out["fold_shortlist_hit_grid1024"] = g["fold_shortlist_hit"]["ms"]
    return out


def level_frames(device) -> dict:
    """The frames and the fit step of the per-level route: ``render`` of
    grid-1024 and grid-2048 at 1920x1080 d3 and of c5 (grid-1024 at
    3840x2160 d4), and the grid-1024 1920x1080 d3 fit step, each with its
    kernel launches counted."""
    from raytracer_tpu_torch.models import scenes
    from raytracer_tpu_torch.utils.profiler import benchmark_fit_step, benchmark_render

    camera = scenes.reference_demo_camera(device=device)
    out = {}
    for name, n, width, height, depth, iters in (
            ("grid1024_1920x1080_d3", 1024, 1920, 1080, 3, 20),
            ("grid2048_1920x1080_d3", 2048, 1920, 1080, 3, 20),
            ("c5_grid1024_3840x2160_d4", 1024, 3840, 2160, 4, 5)):
        scene = scenes.grid_sphere_scene(n, device=device)
        b = benchmark_render(scene, camera, width, height, depth=depth, iters=iters)
        out[name] = dict(frame_ms=b["frame_ms"], frame_ms_all=b["frame_ms_all"])
    lstart, _, _ = level_fit_start(device)
    f = benchmark_fit_step(lstart, camera, 1920, 1080, depth=3, iters=5,
                           optimizer=level_fit_optimizer)
    out["fit_grid1024_1920x1080_d3"] = dict(step_ms=f["step_ms"], step_ms_all=f["step_ms_all"])
    return out


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# The closest-hit diagnosis (fold_shortlist, fold_shortlist_hit) and --hit-only
# ---------------------------------------------------------------------------

# (name, scene, width, height): the primary rays of the depth pass
# (render_depth, one closest_hit_soa call a row chunk) on grid-1024, grid-64
# (4 chunks of 16 spheres), sprint3 (one chunk of one sphere) and grid-2048
# at 1920x1080, on c5 (grid-1024 at 3840x2160, 4 row chunks) and on
# BASELINE c1 (the demo scene at 320x240, identity lists).
HIT_DIAG_FRAMES = (
    ("grid1024_1920x1080", ("grid_sphere_scene", (1024,)), 1920, 1080),
    ("grid64_1920x1080", ("grid_sphere_scene", (64,)), 1920, 1080),
    ("sprint3_1920x1080", ("sprint3_scene", ()), 1920, 1080),
    ("grid2048_1920x1080", ("grid_sphere_scene", (2048,)), 1920, 1080),
    ("c5_grid1024_3840x2160", ("grid_sphere_scene", (1024,)), 3840, 2160),
    ("c1_demo_320x240", ("reference_demo_scene", ()), 320, 240),
)


def depth_pass_rays(device, width: int, height: int) -> list:
    """``render_depth``'s ``closest_hit_soa`` inputs: the camera rays of
    each row chunk (``_row_chunks``) as ``[rows, W]`` planes ``(o, d, w)``,
    all alive (``cuda_hit._frame``)."""
    from raytracer_tpu_torch.models import scenes
    from raytracer_tpu_torch.ops import cuda_hit
    from raytracer_tpu_torch.ops.trace import raygen_tile
    from raytracer_tpu_torch.render.integrator import _row_chunks

    camera = scenes.reference_demo_camera(device=device)
    rows = _row_chunks(width, height, 0)
    out = []
    for r0 in range(0, height, rows):
        o, d = raygen_tile(camera, width, height, row_offset=r0, rows=min(rows, height - r0))
        out.append(cuda_hit._frame(o, d, None)[:3])
    return out


def hit_smem(tables) -> int:
    """Dynamic shared bytes of a fold_shortlist launch: the package's own
    plan where it has one, else the parent's layout (the table without its
    materials, then the shortlist)."""
    from raytracer_tpu_torch.ops import cuda_hit

    plan = getattr(cuda_hit, "hit_smem_bytes", None)
    if plan is not None:
        return plan(tables)
    c = tables.counts
    return 4 * (tables.packed.numel() - 8 * (c["n_s"] + c["n_w"] + c["n_b"]) + c["n_c"])


def hit_row(tables, o, d, w, reach: bool = True) -> dict:
    """Both shortlist kernels on one ``closest_hit_soa`` call's rays, on
    the shortlists ``cuda_hit.shortlists`` builds: each variant's device
    time (``event_ms``), the lanes alive and the listed chunks a tile; with
    ``reach`` also the chunk reach of a lane and the union of a warp
    (``level_reach``, t1 = t_ex and the fold's final t), the fold's work by
    route from the plain mirror (the package's
    ``fold_shortlist_pair_reference`` where it has one, else the per-level
    ``pair_fold_reference``; the same fold) at its K and the cooperative
    share at each K of PAIR_SWEEP, and whether the fold kernel equals the
    mirror and the record kernel's index the fold's, bit for bit."""
    from raytracer_tpu_torch.core.v3 import V3
    from raytracer_tpu_torch.ops import cuda_hit, cuda_level

    sl = cuda_hit.shortlists(tables, o, d, w)
    t9, i9 = cuda_hit.fold_shortlist(tables, sl, o, d, w)
    row = dict(lanes=w.numel(), alive=int((w > 0).sum()),
               listed=(float(sl[1].clamp_min(0).float().mean()) if sl is not None
                       else float(tables.counts["n_c"])),
               fold_ms=event_ms(lambda: cuda_hit.fold_shortlist(tables, sl, o, d, w)),
               hit_ms=event_ms(lambda: cuda_hit.fold_shortlist_hit(tables, sl, o, d, w)))
    if not reach:
        return row
    if sl is not None:
        row.update(level_reach(tables, sl, o, d, w, t9))
    mirror = getattr(cuda_hit, "fold_shortlist_pair_reference", None)
    k_min = cuda_level.PAIR_MIN_LANES
    if mirror is not None:
        (tm, im), work = mirror(tables, sl, o, d, w, k_min)
        row["mirror_same"] = same_planes(t9, tm) and torch.equal(i9, im)
    else:
        zero = V3(*(torch.zeros_like(w) for _ in range(3)))
        work = cuda_level.pair_fold_reference(tables, sl, o, d, w, zero, True, k_min)[1]
    row["record_index_is_fold"] = torch.equal(cuda_hit.fold_shortlist_hit(tables, sl, o, d, w)[1],
                                              i9)
    row.update(k_min=k_min, fold_work=work,
               lane_reach_exact=work["lane_chunks"] / max(work["used"], 1),
               warp_union_exact=work["warp_chunks"] / max(work["warps"], 1),
               pair_shares=pair_shares(work["pass_hist"], tables.counts["unroll"] <= 16))
    row["warp_ratio_exact"] = row["warp_union_exact"] / max(row["lane_reach_exact"], 1e-30)
    return row


def hit_diagnosis(device, procs=None, reach: bool = True) -> dict:
    """``ptxas -v`` of fold_shortlist (registers, spills) with its blocks
    per SM at each diagnosed scene's shared bytes, then ``hit_row`` for
    each row chunk of HIT_DIAG_FRAMES' depth passes and each level of the
    grid-1024 1920x1080 d3 loop around ``closest_hit_soa``
    (``loop_hit_rays``), with each workload's sums over its launches."""
    from raytracer_tpu_torch.ops import cuda_fold

    out = {"ptxas": ptxas_finish(procs or ptxas_start(("fold_shortlist",))) if reach else [],
           "scenes": {}}
    work = [(name, cuda_fold.fused_tables(make_scene(spec, device)),
             depth_pass_rays(device, width, height))
            for name, spec, width, height in HIT_DIAG_FRAMES]
    work.append(("loop_grid1024_1920x1080_d3", *loop_hit_rays(device)))
    for name, tables, calls in work:
        rows = [hit_row(tables, *c, reach=reach) for c in calls]
        out["scenes"][name] = dict(
            n_c=tables.counts["n_c"], unroll=tables.counts["unroll"], smem=hit_smem(tables),
            rows=rows, fold_ms=[r["fold_ms"] for r in rows], hit_ms=[r["hit_ms"] for r in rows])
        for row in out["ptxas"]:
            key = f"blocks_per_sm_{name}"
            row[key] = occupancy(row, 256, hit_smem(tables))
    return out


def print_hit_diagnosis(diag: dict):
    for row in diag["ptxas"]:
        occ = {k: v for k, v in row.items() if k.startswith("blocks_per_sm")}
        print(f"hit diagnosis ptxas {row['kernel']}: registers={row.get('registers')} "
              f"spill_stores={row.get('spill_stores')} spill_loads={row.get('spill_loads')} "
              f"{occ}", flush=True)
    for name, sc in diag["scenes"].items():
        print(f"hit diagnosis {name}: n_c={sc['n_c']} unroll={sc['unroll']} smem={sc['smem']} "
              f"fold_shortlist_ms={[round(v, 4) for v in sc['fold_ms']]} "
              f"(sum {sum(sc['fold_ms']):.4f}) fold_shortlist_hit_ms="
              f"{[round(v, 4) for v in sc['hit_ms']]} (sum {sum(sc['hit_ms']):.4f})", flush=True)
        for k, r in enumerate(sc["rows"]):
            line = f"  launch {k}: alive={r['alive']} of {r['lanes']} listed={r['listed']:.2f}"
            if "lane_reach_ex" in r:
                line += (f" lane_reach t_ex/final={r['lane_reach_ex']:.3f}/{r['lane_reach_fin']:.3f}"
                         f" warp_union={r['warp_union_ex']:.3f}/{r['warp_union_fin']:.3f}"
                         f" alive_per_warp={r['alive_per_warp']:.2f}")
            if "fold_work" in r:
                wk = r["fold_work"]
                line += (f" exact: lane_reach={r['lane_reach_exact']:.3f} "
                         f"warp_union={r['warp_union_exact']:.3f} "
                         f"ratio={r['warp_ratio_exact']:.3f} at K={r['k_min']}: "
                         f"per_lane={wk['per_lane']} pair={wk['pair']} "
                         f"pair_steps={wk['pair_steps']} pair_shares="
                         + str({k2: round(v['pair_share'], 3)
                                for k2, v in r['pair_shares'].items()})
                         + f" mirror_same={r.get('mirror_same')} "
                         f"record_index_is_fold={r['record_index_is_fold']}")
            print(line, flush=True)


def hit_frames(device, width: int = 1920, height: int = 1080) -> dict:
    """The frames of the closest-hit paths, each the median of 10 calls
    (host clock, ended by a synchronize): ``render_depth`` of grid-1024 at
    ``width`` x ``height`` and of c5 (twice each way: 3840x2160), the
    grid-1024 d3 loop around ``closest_hit_soa`` (``drive_hit_loop``'s
    frame), and the ``"pallas"`` fold pass on grid-1024
    (``drive_fold_pass``'s call)."""
    from raytracer_tpu_torch import render_depth
    from raytracer_tpu_torch.models import scenes
    from raytracer_tpu_torch.ops.tonemap import reinhard_tonemap
    from raytracer_tpu_torch.ops.trace import closest_hit_soa, raygen_tile, render_tile
    from raytracer_tpu_torch.ops.trace import resolve_fold_fn

    camera = scenes.reference_demo_camera(device=device)
    grid = scenes.grid_sphere_scene(1024, device=device)
    start, _, _ = level_fit_start(device, width, height)
    o, d = raygen_tile(camera, width, height)
    fold = resolve_fold_fn("pallas")

    def hit_fn(sc, oo, dd, active=None):
        return closest_hit_soa(sc, oo, dd, active=active)

    calls = {
        "render_depth_grid1024_1920x1080": lambda: render_depth(grid, camera, width, height,
                                                                device=device),
        "render_depth_c5_grid1024_3840x2160": lambda: render_depth(
            grid, camera, 2 * width, 2 * height, device=device),
        "loop_grid1024_1920x1080_d3": lambda: reinhard_tonemap(render_tile(
            start, camera, width, height, depth=3, closest_hit_fn=hit_fn).stacked()),
        "fold_pass_grid1024_1920x1080": lambda: fold(grid, o, d),
    }
    out = {}
    for name, fn in calls.items():
        with torch.no_grad():
            fn()
            times = [_calls_ms(fn, 1) for _ in range(10)]
        out[name] = dict(frame_ms=statistics.median(times), frame_ms_all=times)
    return out


def hit_shared_times(device) -> dict:
    """The kernels that share trace_common.cuh with the closest-hit
    kernels, each on its main frame (``event_ms``): ``shared_kernel_times``
    (trace_whole, trace_whole_bwd, fold_flat, and the two shortlist kernels
    on grid-1024 primary rays), and ``ray_stats`` and the sums of a frame's
    ``trace_level`` and ``trace_level_bwd`` launches on grid-1024 at
    1920x1080 d3 (``level_diagnosis_scene``), and the sum of the
    ``trace_level`` launches of the demo scene at 640x640 d12 (one chunk of
    one sphere, identity lists; ``level_kernels_ms``)."""
    from raytracer_tpu_torch.ops import cuda_fold

    out = shared_kernel_times(device)
    lv = level_diagnosis_scene(1024, 1920, 1080, 3, device, reach=False)
    out.update(ray_stats_grid1024=lv["stats_ms"], trace_level_grid1024=sum(lv["fwd_ms"]),
               trace_level_bwd_grid1024=sum(lv["bwd_ms_list"]))
    demo = cuda_fold.fused_tables(make_scene(("reference_demo_scene", ()), device))
    out["trace_level_demo_640x640_d12"] = level_kernels_ms(
        demo, *frame_rays(640, 640, device), 12)["sum_ms"]
    return out


def hit_failed(diag: dict) -> list:
    """The launches of a closest-hit diagnosis where the fold kernel
    differs from its plain mirror or the record kernel's index from the
    fold's (``hit_row``)."""
    return [f"{name} launch {k}" for name, sc in diag["scenes"].items()
            for k, r in enumerate(sc["rows"])
            if r.get("mirror_same") is False or r.get("record_index_is_fold") is False]


def soft_extras(device) -> dict:
    return {"fits": soft_fit_steps(device)}


def level_extras(device) -> dict:
    return {"frames": level_frames(device), "shared": shared_kernel_times(device)}


def hit_extras(device) -> dict:
    return {"frames": hit_frames(device), "shared": hit_shared_times(device)}


def whole_extras(device) -> dict:
    return {"route": route_rows(device), "shared": hit_shared_times(device)}


def flat_extras(device) -> dict:
    return {"frames": flat_frames(device), "shared": hit_shared_times(device)}


# ---------------------------------------------------------------------------
# The whole-trace diagnosis (trace_whole, trace_whole_bwd) and --whole-only
# ---------------------------------------------------------------------------

# (name, scene, width, height, depth): the whole-trace class's frames, from
# its main path (sprint3) and the reference renderer's default frame (demo
# d10) to its largest scene (grid-768: 24 chunks, a 45 KB table).
WHOLE_DIAG_FRAMES = (
    ("sprint3_1920x1080_d3", ("sprint3_scene", ()), 1920, 1080, 3),
    ("demo_640x640_d10", ("reference_demo_scene", ()), 640, 640, 10),
    *((f"grid{n}_1920x1080_d3", ("grid_sphere_scene", (n,)), 1920, 1080, 3)
      for n in (64, 130, 256, 512, 768)),
)
# The frames diagnosed level by level (lanes, reach, fold work by route).
WHOLE_REACH = ("sprint3_1920x1080_d3", "grid64_1920x1080_d3", "grid768_1920x1080_d3")
# The lane layouts the reach is counted in: warps of 32 consecutive pixels of
# a row (the flat planes in strips of 256), of 2 x 16 pixels (16x16 tiles)
# and of 4 x 8 (32x8 tiles, the kernel's).
WHOLE_LAYOUTS = (("strips", (1, 256)), ("tiles", (16, 16)), ("tiles32x8", (32, 8)))


def whole_smem(tables) -> tuple:
    """Dynamic shared bytes of a trace_whole and a trace_whole_bwd launch:
    the package's own plans where it has them, else the parent's layout (the
    packed table; the backward adds its [n_prim, 14] and light rows)."""
    from raytracer_tpu_torch.ops import cuda_fold

    plan = getattr(cuda_fold, "whole_smem_bytes", None)
    if plan is not None:
        return plan(tables), cuda_fold.whole_bwd_smem_bytes(tables)
    c = tables.counts
    rows = 14 * (c["n_s"] + c["n_w"] + c["n_b"]) + 6 * (c["n_pt"] + c["n_sun"]) + 10
    return tables.smem_bytes, tables.smem_bytes + 4 * rows


def whole_level_rows(tables, o, d, w, depth: int, t_k, i_k, levels) -> list:
    """Per level of one frame: the lanes alive and, in each layout of
    WHOLE_LAYOUTS, the alive lanes of a warp that has one, and from the
    plain mirror ``whole_pair_reference`` at the package's K (the
    per-level ``pair_fold`` in that layout) the chunks a used lane's gate
    passes, their union over its warp, the fold's work by route and the
    cooperative share at each K of PAIR_SWEEP; and whether the kernel's t
    and index equal the mirror's, bit for bit. Without the mirror in the
    package, the lanes only. The backward's winners a warp
    (``bwd_scatter_stats``)."""
    from raytracer_tpu_torch.ops import cuda_fold, cuda_level

    mirror = getattr(cuda_fold, "whole_pair_reference", None)
    rows = [dict(level=k, alive=int((levels.level(k)[2] > 0).sum()),
                 bwd=bwd_scatter_stats(tables, i_k[k], levels.level(k)[2]))
            for k in range(depth + 1)]
    for lay, tile in WHOLE_LAYOUTS:
        if mirror is not None:
            (_, tm, im), works = mirror(tables, o, d, w, depth, tile=tile)
            same = same_planes(t_k, tm) and torch.equal(i_k, im)
            (h, wd), tile = cuda_fold.whole_grid(w.shape, tile, tables)
        else:
            works, same = [None] * (depth + 1), None
            h, wd = (1, w.numel()) if tile[0] == 1 else tuple(w.shape)
        warp = cuda_level.lane_slots((h, wd), tile, w.device)[2]
        n_warps = int(warp.max()) + 1
        for k, row in enumerate(rows):
            lw = levels.level(k)[2].reshape(h, wd)
            per = torch.bincount(warp[lw > 0], minlength=n_warps)
            r = dict(alive_per_warp=float(per[per > 0].float().mean()) if bool((per > 0).any())
                     else 0.0, mirror_same=same)
            work = works[k]
            if work is not None:
                r.update(work=work, lane_reach=work["lane_chunks"] / max(work["used"], 1),
                         warp_union=work["warp_chunks"] / max(work["warps"], 1),
                         pair_shares=pair_shares(work["pass_hist"],
                                                 tables.counts["unroll"] <= 16))
                r["warp_ratio"] = r["warp_union"] / max(r["lane_reach"], 1e-30)
            row[lay] = r
    return rows


def whole_diagnosis(device, procs=None, reach: bool = True) -> dict:
    """``ptxas -v`` of the whole-trace kernels (registers, spills) with
    their blocks per SM at each frame's shared bytes, and for each frame of
    WHOLE_DIAG_FRAMES the kernels' times (``event_ms``): the forward with
    and without its residual planes, the backward on the forward's
    residuals and a seeded image cotangent, with their bounds on the run's
    data; with ``reach``, for the frames of WHOLE_REACH, the per-level rows
    of ``whole_level_rows``."""
    from raytracer_tpu_torch.core.v3 import V3
    from raytracer_tpu_torch.ops import cuda_fold

    rows = ptxas_finish(procs or ptxas_start(("trace_whole", "trace_whole_bwd"))) if reach else []
    out = {"ptxas": rows, "scenes": {}}
    for name, spec, width, height, depth in WHOLE_DIAG_FRAMES:
        scene = make_scene(spec, device)
        tables = cuda_fold.fused_tables(scene)
        o, d, w = frame_rays(width, height, device)
        _, t_k, i_k, res = cuda_fold.trace_whole(tables, o, d, w, depth, emit_res=True)
        levels = cuda_fold.Residuals(o, d, w, t_k, i_k, res)
        attrs, ls = (a.detach() for a in cuda_fold.attribute_tables(scene))
        gen = torch.Generator().manual_seed(1234)
        ct = V3(*(torch.randn(w.shape, generator=gen).to(device) for _ in range(3)))
        alive = torch.stack([levels.level(k)[2] > 0 for k in range(depth + 1)])
        fb, bb = whole_bound(tables, i_k, alive, depth), whole_bwd_bound(tables, levels, depth)
        smem = whole_smem(tables)
        sc = dict(n_c=tables.counts["n_c"], unroll=tables.counts["unroll"], smem=smem,
                  alive=[int(a.sum()) for a in alive],
                  fwd_ms=[event_ms(lambda: cuda_fold.trace_whole(tables, o, d, w, depth))],
                  fwd_res_ms=[event_ms(
                      lambda: cuda_fold.trace_whole(tables, o, d, w, depth, emit_res=True))],
                  bwd_ms=[event_ms(
                      lambda: cuda_fold.trace_whole_bwd(tables, attrs, ls, levels, ct, depth))],
                  bound_ms=fb["bound_ms"], bound_res_ms=fb["bound_res_ms"],
                  bound_by=fb["bound_by"], bwd_bound_ms=bb["bound_ms"],
                  bwd_bound_by=bb["bound_by"])
        if reach and name in WHOLE_REACH:
            sc["levels"] = whole_level_rows(tables, o, d, w, depth, t_k, i_k, levels)
        for row in rows:
            fwd = row["source"] == "trace_whole"
            row[f"blocks_per_sm_{name}"] = occupancy(row, 256, smem[0] if fwd else smem[1])
        out["scenes"][name] = sc
    return out


def print_whole_diagnosis(diag: dict):
    for row in diag["ptxas"]:
        occ = {k: v for k, v in row.items() if k.startswith("blocks_per_sm")}
        print(f"whole diagnosis ptxas {row['kernel']}: registers={row.get('registers')} "
              f"spill_stores={row.get('spill_stores')} spill_loads={row.get('spill_loads')} "
              f"{occ}", flush=True)
    for name, sc in diag["scenes"].items():
        print(f"whole diagnosis {name}: n_c={sc['n_c']} unroll={sc['unroll']} smem={sc['smem']} "
              f"alive={sc['alive']} trace_whole_ms={sc['fwd_ms'][0]:.4f} "
              f"emit_res_ms={sc['fwd_res_ms'][0]:.4f} (bound {sc['bound_ms']:.4f} / "
              f"{sc['bound_res_ms']:.4f} {sc['bound_by']}) trace_whole_bwd_ms="
              f"{sc['bwd_ms'][0]:.4f} (bound {sc['bwd_bound_ms']:.4f} {sc['bwd_bound_by']})",
              flush=True)
        for r in sc.get("levels", []):
            line = (f"  level {r['level']}: alive={r['alive']} bwd winners_per_warp="
                    f"{r['bwd']['winners_per_warp']:.3f} wall_box_warps={r['bwd']['wall_box_warps']}")
            for lay, _ in WHOLE_LAYOUTS:
                x = r[lay]
                line += f"; {lay}: alive_per_warp={x['alive_per_warp']:.2f}"
                if "work" in x:
                    wk = x["work"]
                    line += (f" lane_reach={x['lane_reach']:.3f} warp_union={x['warp_union']:.3f}"
                             f" ratio={x['warp_ratio']:.3f} per_lane={wk['per_lane']}"
                             f" pair={wk['pair']} pair_steps={wk['pair_steps']} pair_shares="
                             + str({k: round(v["pair_share"], 3)
                                    for k, v in x["pair_shares"].items()})
                             + f" mirror_same={x['mirror_same']}")
            print(line, flush=True)


def whole_failed(diag: dict) -> list:
    """The frames and levels of a whole-trace diagnosis where the forward
    kernel differs from its plain mirror."""
    return [f"{name} ({lay})" for name, sc in diag["scenes"].items()
            for lay, _ in WHOLE_LAYOUTS
            if any(r[lay]["mirror_same"] is False for r in sc.get("levels", []))]


def route_rows(device) -> dict:
    """``whole_vs_levels``' times as one flat dict (``<grid>_<measure>``),
    and its selection mismatches."""
    keys = ("whole_ms", "whole_call_ms", "levels_call_ms", "whole_bwd_ms",
            "levels_bwd_kernels_ms", "whole_bwd_call_ms", "levels_bwd_call_ms")
    out = {}
    for row in whole_vs_levels(device):
        out[f"{row['name']}_levels_kernels_ms"] = row["kernels"]["sum_ms"]
        out.update({f"{row['name']}_{k}": row[k] for k in keys})
        out[f"{row['name']}_mismatches"] = row["mismatches"]
    return out


# ---------------------------------------------------------------------------
# The brute-force fold's diagnosis (fold_flat) and --flat-only
# ---------------------------------------------------------------------------

# (name, scene, width, height): primary rays of BASELINE c1 (the demo scene
# at 320x240), of sprint3 at 1920x1080 (the render(fold="pallas_flat")
# frame), of boxes (the mixed scene) and walls only at 256x128, of grid-64,
# of grid-130 at 333x111 (a ragged sphere tile and batch), of grid-1024 and
# grid-2048 at 1920x1080, and of grid-4096 and grid-8192 at 480x270 (tables
# of 64 and 128 KB, past one tile of the first design's 4 KB), and grid-5000
# at 480x270 (its spheres in tiles of 2048, 2048 and a ragged 904).
FLAT_DIAG_FRAMES = (
    ("c1_demo_320x240", ("reference_demo_scene", ()), 320, 240),
    ("sprint3_1920x1080", ("sprint3_scene", ()), 1920, 1080),
    ("mixed_256x128", ("mixed_primitive_scene", ()), 256, 128),
    ("walls_only_256x128", ("walls_only", ()), 256, 128),
    ("grid64_1920x1080", ("grid_sphere_scene", (64,)), 1920, 1080),
    ("grid130_333x111", ("grid_sphere_scene", (130,)), 333, 111),
    ("grid1024_1920x1080", ("grid_sphere_scene", (1024,)), 1920, 1080),
    ("grid2048_1920x1080", ("grid_sphere_scene", (2048,)), 1920, 1080),
    ("grid4096_480x270", ("grid_sphere_scene", (4096,)), 480, 270),
    ("grid8192_480x270", ("grid_sphere_scene", (8192,)), 480, 270),
    ("grid5000_480x270", ("grid_sphere_scene", (5000,)), 480, 270),
)
# Where the diagnosis runs the plain mirror (``fold_flat_mirror``) for the
# share of ray-sphere tests that reach the square root: grid-1024 1080p's
# primary rays and level 2 of its d3 loop.
FLAT_ROOTS = (("grid1024_1920x1080", 0), ("loop_grid1024_1920x1080_d3", 2))
# FP32 lanes of the H100 SXM: 132 SMs of 128. Built with -fmad=false, a
# lane retires one float32 operation a cycle, so ``flat_ops`` over this at
# the SM clock is the fold's issue-slot floor (half the 67 TFLOP/s bound's
# rate, which counts an FMA as two operations).
FP32_LANES = 132 * 128


def flat_smem(tables) -> int:
    """Dynamic shared bytes of a fold_flat launch: the package's plan where
    it has one, else 0 (the first design's 4 KB tile is static)."""
    from raytracer_tpu_torch.ops import cuda_hit

    plan = getattr(cuda_hit, "flat_smem_bytes", None)
    return 0 if plan is None else plan(tables)


def flat_row(tables, o, d, root: bool = False) -> dict:
    """``fold_flat`` on one set of rays (any shape; the flat fold has no
    alive mask): its device time (``event_ms``), its bound on this run's
    data (32 bytes a ray at 3.35 TB/s against ``flat_ops`` at 67 TFLOP/s:
    its distinct origins and the tests that reach the root) and the share
    of it, whether it equals ``fold_flat_reference`` bit for bit; with
    ``root``, the plain mirror's work (``fold_flat_mirror``, where the
    package has it): the share of ray-sphere tests that reach the square
    root, and of the warps' guard branches that are taken, and whether the
    mirror equals the kernel."""
    from raytracer_tpu_torch.ops import cuda_hit

    n = d.x.numel()
    ops, need = flat_ops(tables, o, d)
    nbytes = 32 * n
    t, i = cuda_hit.fold_flat(tables, o, d)
    t_ref, i_ref = cuda_hit.fold_flat_reference(tables, o, d)
    ms = event_ms(lambda: cuda_hit.fold_flat(tables, o, d))
    bound = max(nbytes / PEAK_BYTES_S, ops / PEAK_F32_S) * 1e3
    row = dict(lanes=n, ms=ms, bound_ms=bound, share=bound / ms, gflop=ops / 1e9,
               bound_by="bytes" if nbytes / PEAK_BYTES_S >= ops / PEAK_F32_S else "operations",
               same=same_planes(t, t_ref) and torch.equal(i, i_ref),
               hits=int((i >= 0).sum()), ops=ops, origins=need["origins"],
               roots=need["roots"])
    mirror = getattr(cuda_hit, "fold_flat_mirror", None)
    if root and mirror is not None and tables.counts["n_s"]:
        (tm, im), work = mirror(tables, o, d)
        row.update(mirror_same=same_planes(t, tm) and torch.equal(i, im), work=work,
                   root_share=work["roots"] / max(work["tests"], 1),
                   branch_share=work["branches_taken"] / max(work["branches"], 1))
    return row


def sm_clocks(fn, launches: int = 400, samples: int = 5) -> dict:
    """The SM clock while the card runs ``launches`` calls of ``fn``,
    queued at once: ``nvidia-smi``'s ``clocks.sm`` sampled ``samples``
    times before the queue drains, and ``clocks.max.sm`` (MHz)."""
    for _ in range(launches):
        fn()
    got = []
    for _ in range(samples):
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader,nounits"],
            check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
        got.append([int(v) for v in out.split(",")])
    torch.cuda.synchronize()
    return dict(sm_mhz=[g[0] for g in got], max_mhz=got[0][1])


def flat_diagnosis(device, procs=None, reach: bool = True) -> dict:
    """``ptxas -v`` of fold_flat (registers, spills) with its blocks per SM
    at each frame's shared bytes, then ``flat_row`` for the primary rays of
    each frame of FLAT_DIAG_FRAMES and for each level of the grid-1024
    1920x1080 d3 loop (``loop_hit_rays``: the rays ``render(fold=
    "pallas_flat")`` folds there, dead lanes included), with the mirror's
    root shares at FLAT_ROOTS (with ``reach``), each workload's issue-slot
    floor at the SM clock measured under load on grid-1024, and that
    clock."""
    from raytracer_tpu_torch.ops import cuda_fold, cuda_hit

    rows = ptxas_finish(procs or ptxas_start(("fold_flat",))) if reach else []
    block = getattr(cuda_hit, "FLAT_BLOCK", 256)
    out = {"ptxas": rows, "scenes": {}}
    work = [(name, cuda_fold.fused_tables(make_scene(spec, device)),
             [frame_rays(width, height, device)[:2]])
            for name, spec, width, height in FLAT_DIAG_FRAMES]
    ltables, calls = loop_hit_rays(device)
    work.append(("loop_grid1024_1920x1080_d3", ltables, [c[:2] for c in calls]))
    for name, tables, sets in work:
        c = tables.counts
        launches = [flat_row(tables, o, d, reach and (name, k) in FLAT_ROOTS)
                    for k, (o, d) in enumerate(sets)]
        out["scenes"][name] = dict(
            n_s=c["n_s"], n_w=c["n_w"], n_b=c["n_b"], smem=flat_smem(tables),
            ms=[r["ms"] for r in launches], bound_ms=[r["bound_ms"] for r in launches],
            share=[r["share"] for r in launches], rows=launches)
        for row in rows:
            row[f"blocks_per_sm_{name}"] = occupancy(row, block, flat_smem(tables))
    g_tables, ((go, gd),) = next((t, r) for n, t, r in work if n == "grid1024_1920x1080")
    clocks = sm_clocks(lambda: cuda_hit.fold_flat(g_tables, go, gd))
    out["clocks"] = clocks
    ghz = statistics.median(clocks["sm_mhz"]) / 1e3
    for sc in out["scenes"].values():
        sc["issue_floor_ms"] = [r["ops"] / (FP32_LANES * ghz * 1e9) * 1e3 for r in sc["rows"]]
    return out


def print_flat_diagnosis(diag: dict):
    for row in diag["ptxas"]:
        occ = {k: v for k, v in row.items() if k.startswith("blocks_per_sm")}
        print(f"flat diagnosis ptxas {row['kernel']}: registers={row.get('registers')} "
              f"spill_stores={row.get('spill_stores')} spill_loads={row.get('spill_loads')} "
              f"static_smem={row.get('static_smem')} {occ}", flush=True)
    print(f"flat diagnosis SM clock under load (MHz): {diag['clocks']}", flush=True)
    for name, sc in diag["scenes"].items():
        print(f"flat diagnosis {name}: n_s={sc['n_s']} n_w={sc['n_w']} n_b={sc['n_b']} "
              f"smem={sc['smem']} fold_flat_ms={[round(v, 4) for v in sc['ms']]} "
              f"bound_ms={[round(v, 4) for v in sc['bound_ms']]} "
              f"share_of_bound={[round(v, 3) for v in sc['share']]} "
              f"issue_floor_ms={[round(v, 4) for v in sc['issue_floor_ms']]}", flush=True)
        for k, r in enumerate(sc["rows"]):
            line = (f"  launch {k}: lanes={r['lanes']} hits={r['hits']} {r['gflop']:.4g} GFLOP "
                    f"({r['bound_by']}; origins={r['origins']} roots={r['roots']}) "
                    f"bit_for_bit={r['same']}")
            if "work" in r:
                wk = r["work"]
                line += (f" mirror_same={r['mirror_same']} tests={wk['tests']} "
                         f"root_share={r['root_share']:.5f} branches={wk['branches']} "
                         f"taken_share={r['branch_share']:.5f} "
                         f"one_origin_groups={wk['one_origin_groups']} of {wk['groups']}")
            print(line, flush=True)


def flat_failed(diag: dict) -> list:
    """The launches of a flat diagnosis where the kernel differs from its
    plain version or its plain mirror."""
    return [f"{name} launch {k}" for name, sc in diag["scenes"].items()
            for k, r in enumerate(sc["rows"])
            if not r["same"] or r.get("mirror_same") is False]


def check_flat_plan(device) -> bool:
    """Whether ``cuda_hit.flat_plan``'s shared bytes equal csrc/fold_flat.cu's
    ``fold_flat_smem_bytes`` at its tile, for each scene of
    FLAT_DIAG_FRAMES (whole tables, tables in tiles of 2048 spheres, a
    ragged last tile; no spheres)."""
    from raytracer_tpu_torch.ops import _build, cuda_fold, cuda_hit

    lib = _build.load("fold_flat", cuda_hit._SIGNATURES["fold_flat"])
    ok = True
    for _, spec, _, _ in FLAT_DIAG_FRAMES:
        tables = cuda_fold.fused_tables(make_scene(spec, device))
        c = tables.counts
        tile, smem = cuda_hit.flat_plan(tables)
        ok &= lib.fold_flat_smem_bytes(c["n_s"], c["n_w"], c["n_b"], tile) == smem
    return ok


def flat_frames(device, width: int = 1920, height: int = 1080, depth: int = 3) -> dict:
    """``render(fold="pallas_flat")`` and ``render()`` (the default route)
    of sprint3 and grid-1024 at ``width`` x ``height``, depth ``depth``
    (``benchmark_render``, median of 20 frames)."""
    from raytracer_tpu_torch.models import scenes
    from raytracer_tpu_torch.utils.profiler import benchmark_render

    camera = scenes.reference_demo_camera(device=device)
    out = {}
    for name, scene in (("sprint3", scenes.sprint3_scene(device=device)),
                        ("grid1024", scenes.grid_sphere_scene(1024, device=device))):
        for fold in ("pallas_flat", "auto"):
            b = benchmark_render(scene, camera, width, height, depth=depth, iters=20, fold=fold)
            out[f"{name}_{width}x{height}_d{depth}_{fold}"] = dict(
                frame_ms=b["frame_ms"], frame_ms_all=b["frame_ms_all"])
    return out


# --MODE-only and --MODE-compare: per mode the kernels built, those whose
# ``ptxas -v`` the diagnosis reads, the diagnosis and its printer, the
# launch lists of each diagnosed scene that --MODE-compare sets side by
# side, the measurements after the diagnosis (name -> {case: value}), and
# the check that fails the run.
COMPARE_MODES = {
    "soft": dict(build=("soft_level", "soft_level_bwd"), ptxas=("soft_level", "soft_level_bwd"),
                 diagnose=soft_diagnosis, show=print_soft_diagnosis,
                 per_launch=("fwd_ms", "bwd_ms"), extras=soft_extras,
                 failed=lambda diag: []),
    "level": dict(build=("ray_stats", "trace_level", "trace_level_bwd", "trace_whole",
                         "trace_whole_bwd", "fold_flat", "fold_shortlist"),
                  ptxas=("ray_stats", "trace_level", "trace_level_bwd"),
                  diagnose=level_diagnosis, show=print_level_diagnosis,
                  per_launch=("fwd_ms", "bwd_ms_list"), extras=level_extras,
                  failed=lambda diag: []),
    "hit": dict(build=("fold_shortlist", "ray_stats", "trace_level", "trace_level_bwd",
                       "trace_whole", "trace_whole_bwd", "fold_flat"),
                ptxas=("fold_shortlist",), diagnose=hit_diagnosis, show=print_hit_diagnosis,
                per_launch=("fold_ms", "hit_ms"), extras=hit_extras, failed=hit_failed),
    "whole": dict(build=("trace_whole", "trace_whole_bwd", "ray_stats", "trace_level",
                         "trace_level_bwd", "fold_flat", "fold_shortlist"),
                  ptxas=("trace_whole", "trace_whole_bwd"), diagnose=whole_diagnosis,
                  show=print_whole_diagnosis, per_launch=("fwd_ms", "fwd_res_ms", "bwd_ms"),
                  extras=whole_extras, failed=whole_failed),
    "flat": dict(build=("fold_flat", "fold_shortlist", "ray_stats", "trace_level",
                        "trace_level_bwd", "trace_whole", "trace_whole_bwd"),
                 ptxas=("fold_flat",), diagnose=flat_diagnosis, show=print_flat_diagnosis,
                 per_launch=("ms",), extras=flat_extras, failed=flat_failed),
}


def _scalar(v):
    """The number --MODE-compare sets side by side for one measurement."""
    if isinstance(v, dict):
        v = v.get("step_ms", v.get("frame_ms", "raises"))
    return f"{v:.4f}" if isinstance(v, float) else v


def only(mode: str) -> int:
    """``--MODE-only`` (``COMPARE_MODES``): the card's line, the build of
    the mode's kernels, its diagnosis and its measurements, then one JSON
    line of them all. Run by ``--MODE-compare`` on each tree it compares.
    Exits 1 if the diagnosis found a kernel at odds with its plain mirror."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import raytracer_tpu_torch
    from raytracer_tpu_torch.ops import _build

    m = COMPARE_MODES[mode]
    root = str(Path(raytracer_tpu_torch.__file__).resolve().parents[1])
    smi = card_line()
    print(f"{smi} (package at {root})", flush=True)
    t0 = time.perf_counter()
    procs = ptxas_start(m["ptxas"])
    _build.build(list(m["build"]))
    print(f"build: {', '.join(m['build'])} {time.perf_counter() - t0:.1f} s", flush=True)
    diag = m["diagnose"]("cuda", procs)
    m["show"](diag)
    result = {"root": root, "card": smi, "diagnosis": diag, **m["extras"]("cuda")}
    for key in result:
        if key not in ("root", "card", "diagnosis"):
            for name, v in result[key].items():
                print(f"{mode} {key} {name}: {v}", flush=True)
    for row in diag["ptxas"]:
        del row["cubin"]
    print(json.dumps({f"{mode}_compare": result}), flush=True)
    failed = m["failed"](diag)
    if failed:
        print(f"chip_smoke: --{mode}-only: a kernel differs from its plain mirror: {failed}",
              file=sys.stderr)
        return 1
    return 0


def compare(mode: str, parent: str, out: str | None = None) -> int:
    """``--MODE-compare PARENT``: ``--MODE-only`` on the package unpacked at
    PARENT and on this checkout's, in turns (parent, change, change,
    parent) on the same card, each in its own process; prints each run and
    a summary, and writes the runs to ``out`` as JSON if given."""
    here = str(Path(__file__).resolve().parent)
    tag = f'{{"{mode}_compare"'
    runs = []
    for root in (parent, here, here, parent):
        cmd = [sys.executable, str(Path(__file__).resolve()), f"--{mode}-only", "--root", root]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        lines = proc.stdout.splitlines()
        for line in lines:
            if not line.startswith(tag):
                print(f"[{'parent' if root == parent else 'change'}] {line}", flush=True)
        if proc.returncode:
            print(proc.stderr[-6000:], file=sys.stderr)
            return proc.returncode
        runs.append(json.loads(next(x for x in lines if x.startswith(tag))))
    if out:
        Path(out).write_text(json.dumps(runs))
    names = ("parent", "change", "change", "parent")
    rc = [r[f"{mode}_compare"] for r in runs]
    for scene in rc[0]["diagnosis"]["scenes"]:
        for key in COMPARE_MODES[mode]["per_launch"]:
            print(f"{mode} compare {scene} {key} per launch: "
                  + " ".join(f"{names[i]}={[round(v, 4) for v in rc[i]['diagnosis']['scenes'][scene][key]]}"
                             for i in range(4)), flush=True)
    for key in rc[0]:
        if key in ("root", "card", "diagnosis"):
            continue
        for name in rc[0][key]:
            print(f"{mode} compare {key} {name}: "
                  + " ".join(f"{names[i]}={_scalar(rc[i][key][name])}" for i in range(4)),
                  flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from raytracer_tpu_torch.ops import _build, cuda_fold, cuda_hit, cuda_level
    from raytracer_tpu_torch.utils.profiler import (
        benchmark_fit_step,
        benchmark_forward_backward,
        benchmark_render,
    )
    from raytracer_tpu_torch.models import scenes

    smi = card_line()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    kernels_built = ["trace_whole", "trace_whole_bwd", "ray_stats", "trace_level",
                     "trace_level_bwd", "soft_level", "soft_level_bwd", "fold_flat",
                     "fold_shortlist"]
    soft_ptxas = ptxas_start()  # the soft diagnosis's ptxas reports, built beside the kernels
    _build.build(kernels_built)
    print(f"build: {', '.join(kernels_built)} {time.perf_counter() - t0:.1f} s", flush=True)

    failed = []

    def check(name: str, passed) -> None:
        if not passed:
            failed.append(name)
    results, bwd_results = [], []
    for case in CASES:
        r = check_trace_whole(case, "cuda")
        results.append(r)
        check(f"trace_whole {r['name']}", r["ok"])
        print(
            f"trace_whole {r['name']}: ok={r['ok']} alive={r['alive']} "
            f"mismatches={r['mismatches']} t_rel_max={r['t_rel_max']:.3g} "
            f"max_abs_err={r['max_abs_err']:.3g} dead_ok={r['dead_ok']} "
            f"nonfinite_like_plain={r['nonfinite']} "
            f"emit_res: same={r['emit_same']} res_mismatches={r['res_mismatches']} "
            f"ms={r['ms']:.4f} ms_res={r['ms_res']:.4f} plain_ms={r['plain_ms']:.2f} "
            f"bound_ms={r['bound_ms']:.4f} bound_res_ms={r['bound_res_ms']:.4f} "
            f"({r['bound_by']})", flush=True,
        )
        for line in r["mismatch_lines"]:
            print(line)
        b = check_trace_whole_bwd(r.pop("forward"), r["name"], "cuda")
        bwd_results.append(b)
        check(f"trace_whole_bwd {b['name']}", b["ok"])
        print(
            f"trace_whole_bwd {b['name']}: ok={b['ok']} alive={b['alive']} "
            f"plane_exceptions={b['plane_exceptions']} "
            f"plane_max_abs_err={ {k: float(f'{v:.3g}') for k, v in b['plane_err'].items()} } "
            f"leaf_rel_max={b['leaf_rel_max']:.3g} leaf_max_abs_err={b['leaf_err_max']:.3g} "
            f"max_rel_err={b['max_rel_err']:.3g} max|plain|: planes={b['plane_scale']:.3g} "
            f"leaves={b['leaf_scale']:.3g} nonfinite_in_plain={b['nonfinite']} "
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
        check(f"per-level chain {r['name']}", r["ok"])
        print_level(r)
    lmain = level_results[0]
    edges = check_cull_edges("cuda")
    check("stats cull on edge rays", edges["ok"])
    print(f"stats cull on edge rays (zero, tiny and non-finite directions) grid1024 96x64: "
          f"{edges}", flush=True)

    sweep = tile_sweep("cuda")
    for row in sweep:
        print(f"tile sweep grid1024 1920x1080 d3 tile={row['tile']}: "
              f"kernels_ms={row['sum_ms']:.4f} ray_stats={row['stats_ms']:.4f} "
              f"trace_level={[round(v, 4) for v in row['level_ms']]} "
              f"listed_chunks={[round(v, 2) for v in row['listed']]}", flush=True)
    best = min(sweep, key=lambda row: row["sum_ms"])
    print(f"tile sweep: fastest {best['tile']}, default LEVEL_TILE {cuda_level.LEVEL_TILE}",
          flush=True)
    route = whole_vs_levels("cuda", ROUTE_GRIDS + ROUTE_GRIDS_PAST)
    for row in route:
        if row["n_c"] <= cuda_fold.FUSED_MAX_CHUNKS:  # the rows past the class inform only
            check(f"whole vs per-level {row['name']}", row["mismatches"] <= 1e-5 * row["alive"])
        k = row["kernels"]
        print(f"whole vs per-level {row['name']} 1920x1080 d3 ({row['n_c']} chunks, table "
              f"{row['table_bytes']} B): forward trace_whole_ms={row['whole_ms']:.4f} "
              f"per_level_kernels_ms={k['sum_ms']:.4f} (ray_stats {k['stats_ms']:.4f}, "
              f"trace_level {[round(v, 4) for v in k['level_ms']]}, listed "
              f"{[round(v, 2) for v in k['listed']]}) call_ms whole={row['whole_call_ms']:.4f} "
              f"per_level={row['levels_call_ms']:.4f}; backward trace_whole_bwd_ms="
              f"{row['whole_bwd_ms']:.4f} per_level_kernels_ms={row['levels_bwd_kernels_ms']:.4f} "
              f"call_ms whole={row['whole_bwd_call_ms']:.4f} "
              f"per_level={row['levels_bwd_call_ms']:.4f}; "
              f"selection_mismatches={row['mismatches']} of {row['alive']} alive "
              f"t_equal_where_same={row['t_equal']}", flush=True)
        if row["arbitration"]:
            print(f"route mismatches {row['name']} 1920x1080 d3, fold_flat as arbiter: "
                  f"{row['arbitration']}", flush=True)

    # ---- small scenes: sprint3 render and fit (the whole-trace kernels) ----
    img, launches = drive_main_path("cuda")
    main_ok = launches["trace_whole"] > 0
    demo_launches = count_launches_demo("cuda")
    im = check_image(img, 1920, 1080, "cuda")
    bench = benchmark_render(
        scenes.sprint3_scene(device="cuda"), scenes.reference_demo_camera(device="cuda"),
        1920, 1080, depth=3, iters=20,
    )
    check("main path render sprint3", main_ok and im["ok"])
    main, bmain = results[0], bwd_results[0]
    print(
        f"main path render sprint3 1920x1080 d3: launches={launches} ok={main_ok and im['ok']} "
        f"image={im} frame_ms={bench['frame_ms']:.4f} "
        f"rays_per_s={bench['primary_rays_per_s']:.4g} "
        f"trace_whole_ms={main['ms']:.4f} plain_ms={main['plain_ms']:.2f}", flush=True,
    )

    train = drive_training_path("cuda")
    check("main path fit sprint3", train["ok"])
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

    print(f"demo render 640x640 d10 launches per frame: {demo_launches}", flush=True)

    # ---- large scenes: grid-1024 render (1080p d3, c5 4K d4) and fit (per-level) ----
    grid = scenes.grid_sphere_scene(1024, device="cuda")
    img, level_launches = drive_level_path("cuda")
    lim = check_level_image(img, 1920, 1080, "cuda")
    level_ok = (level_launches == launches_of(ray_stats=1, trace_level=4)) and lim["ok"]
    check("main path render grid1024", level_ok)
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
    check("main path render c5", c5_ok)
    c5 = benchmark_render(grid, camera, 3840, 2160, depth=4, iters=5)
    print(
        f"main path render c5 grid1024 3840x2160 d4 (4 row chunks): launches={c5_launches} "
        f"ok={c5_ok} image={c5_img} frame_ms={c5['frame_ms']:.4f} "
        f"rays_per_s={c5['primary_rays_per_s']:.4g} "
        f"(all {[round(v, 4) for v in c5['frame_ms_all']]})", flush=True,
    )
    ltrain = drive_level_training("cuda")
    check("main path fit grid1024", ltrain["ok"])
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

    # ---- the soft renderer: c4 render and fit, the large soft fits (kernels 6-7) ----
    soft_results = []
    for case in SOFT_CASES:
        r = check_soft(case, "cuda")
        soft_results.append(r)
        check(f"soft {r['name']}", r["ok"])
        print_soft(r)
    smain = soft_results[0]
    plan_ok = soft_plan_matches("cuda")
    check("soft launch plan", plan_ok)
    print(f"soft launch plan: shared bytes of cuda_soft.soft_launch_plan equal the kernels' "
          f"own on every soft workload: {plan_ok}", flush=True)
    sdiag = soft_diagnosis("cuda", procs=soft_ptxas)
    print_soft_diagnosis(sdiag)
    srender = drive_soft_render("cuda")
    check("main path render_soft c4", srender["ok"])
    print(
        f"main path render_soft c4 grid64 1920x1080 d1: launches={srender['launches']} "
        f"plain_calls_on_cuda={srender['plain_calls']} batch_1d_ok={srender['batch_1d_ok']} "
        f"ok={srender['ok']} "
        f"image={srender['image']} frame_ms={srender['frame_ms']:.4f} "
        f"(all {[round(v, 4) for v in srender['frame_ms_all']]})", flush=True,
    )
    sfit = drive_soft_fit("cuda")
    check("main path soft fit c4", sfit["ok"])
    _, sstart, _, _ = soft_fit_start("cuda")
    c4 = benchmark_fit_step(sstart, camera, 1920, 1080, depth=1, soft=True, iters=10)
    print(
        f"main path soft fit c4 grid64 1920x1080 d1, {len(sfit['losses'])} make_fit_step(soft=True) "
        f"steps: launches={sfit['launches']} per_step={sfit['per_step'][0]} "
        f"plain_calls_on_cuda={sfit['plain_calls']} ok={sfit['ok']} "
        f"losses={[float(f'{v:.6g}') for v in sfit['losses']]} "
        f"center_errors={[float(f'{v:.5g}') for v in sfit['errors']]} "
        f"step_ms={c4['step_ms']:.4f} (all {[round(v, 4) for v in c4['step_ms_all']]})",
        flush=True,
    )
    spans = span_medians("cuda")
    for kind, med in spans.items():
        print(f"span registry {kind} (medians a request over {med.pop('requests')}, ms; "
              f"counters): {json.dumps(med)}", flush=True)
    fits_n = {}
    for n in (1024, 2048, 4096):  # bench.py's two large soft fits, and 4096 spheres
        reset_launches()
        fit_n = benchmark_fit_step(scenes.grid_sphere_scene(n, device="cuda"), camera, 1920, 1080,
                                   depth=1, soft=True, iters=3)
        torch.cuda.synchronize()
        n_launches = read_launches()  # 4 steps: one untimed, 3 timed
        check(f"soft fit grid{n} launches", n_launches == launches_of(soft_level=8, soft_level_bwd=8))
        fits_n[n] = dict(step_ms=fit_n["step_ms"], launches=n_launches["soft_level"])
        print(f"soft fit step grid{n} 1920x1080 d1: launches={n_launches} "
              f"step_ms={fit_n['step_ms']:.4f} (all {[round(v, 4) for v in fit_n['step_ms_all']]})",
              flush=True)

    # ---- the app phase: the c4 fit app and the command line (app/, io/, utils/) ----
    app = drive_app("cuda")
    for part in app_failures(app):
        check(f"app {part}", False)
    print_app(app)

    # ---- the distribution phase: parallel/ on a one-rank NCCL group, then two
    # gloo ranks on the one card ----
    dist_r = drive_dist("cuda:0")
    for part in dist_failures(dist_r):
        check(f"dist {part}", False)
    print_dist(dist_r, smi)

    # ---- the closest-hit API: render_depth, render(fold=...), the per-level
    # loop around closest_hit_soa (kernels 8-10) ----
    hit_results = []
    for case in HIT_CASES:
        r = check_hit(case, "cuda")
        hit_results.append(r)
        check(f"closest-hit {r['name']}", r["ok"])
        print_hit(r)
    canary_rows, canary = flat_canary("cuda")
    for row in canary_rows:
        check(f"fold_flat canary level {row['level']}", row["differ_unit"] == 0)
        print(f"fold_flat vs fold_shortlist, grid1024 1920x1080 bounce level {row['level']}: "
              f"alive={row['alive']} non_unit_directions={row['non_unit']} "
              f"differing_lanes={row['differ']} (at unit directions {row['differ_unit']})",
              flush=True)
    hit_times, hit_loop = {}, []
    for name, spec, width, height in HIT_TIME_CASES:
        hit_times[name] = time_hit(spec, width, height, "cuda",
                                   loop_depth=3 if name == "grid1024_1920x1080" else None)
        hit_loop = hit_times[name].pop("loop_levels", hit_loop)
        check(f"closest-hit times {name}", all(v["same"] for v in hit_times[name].values()))
        print(f"closest-hit times {name} (ms per launch, CUDA events; primary rays): "
              + " ".join(f"{k} {v['ms']:.4f} (bound {v['bound_ms']:.4f} {v['bound_by']}: "
                         f"{v['mbytes']:.1f} MB, {v['gflop']:.3g} GFLOP, listed chunks "
                         f"{v['listed']:.2f}; plain {v['plain_ms']:.2f}, bit for bit {v['same']})"
                         for k, v in hit_times[name].items()), flush=True)
    fdiag = flat_diagnosis("cuda", reach=False)
    check("fold_flat diagnosis", not flat_failed(fdiag))
    print_flat_diagnosis(fdiag)
    fplan = check_flat_plan("cuda")
    check("fold_flat launch plan", fplan)
    print(f"fold_flat launch plan equals the kernel's shared layout on every flat diagnosis "
          f"scene: {fplan}", flush=True)
    for k, lv in enumerate(hit_loop):
        check(f"closest-hit loop level {k}", all(v["same"] for v in lv.values()))
        print(f"closest-hit times grid1024_1920x1080 loop level {k} (ms per launch, CUDA events): "
              + " ".join(f"{n} {v['ms']:.4f} (bound {v['bound_ms']:.4f} {v['bound_by']}, alive "
                         f"{v['alive']}, listed chunks {v['listed']:.2f}, bit for bit with the "
                         f"plain version {v['same']})" for n, v in lv.items()),
              flush=True)
    for row in cutoff_sweep("cuda"):
        print(f"cut-off sweep 1920x1080 primary rays, {row['n_prim']} primitives: "
              f"fold_shortlist_hit call {row['record_ms']:.4f} ms, fold_shortlist + hit_record "
              f"call {row['fold_hit_record_ms']:.4f} ms (rounds {row['rounds']})", flush=True)
    depth_paths = {}
    for name, spec, width, height, reference in (
            ("c1_demo_320x240", ("reference_demo_scene", ()), 320, 240, True),
            ("grid1024_1920x1080", ("grid_sphere_scene", (1024,)), 1920, 1080, True),
            ("c5_grid1024_3840x2160", ("grid_sphere_scene", (1024,)), 3840, 2160, False)):
        r = drive_depth("cuda", spec, width, height, reference)
        depth_paths[name] = r
        check(f"render_depth {name}", r["ok"])
        print(f"main path render_depth {name}: launches={r['launches']} ok={r['ok']} "
              f"plain_calls_on_cuda={r['plain_calls']} shape={r['shape']} "
              f"inf_share={r['inf_share']:.4f} "
              + (f"plain_fold_equal={r['plain_equal']} plain_max_abs_err="
                 f"{r['plain_max_abs_err']:.3g} " if reference else "")
              + f"frame_ms={r['frame_ms']:.4f} (all {[round(v, 4) for v in r['frame_ms_all']]})",
              flush=True)
    fold_passes = {}
    for name, spec, width, height in (
            ("c1_demo_320x240", ("reference_demo_scene", ()), 320, 240),
            ("grid1024_1920x1080", ("grid_sphere_scene", (1024,)), 1920, 1080)):
        r = drive_fold_pass("cuda", spec, width, height)
        fold_passes[name] = r
        check(f"fold pass {name}", r["ok"])
        print(f"main path fold pass (resolve_fold_fn('pallas'), (t, index)) {name}: "
              f"launches={r['launches']} ok={r['ok']} plain_calls_on_cuda={r['plain_calls']} "
              f"hits={r['hits']} plain_fold_equal={r['plain_equal']} "
              f"call_ms={r['call_ms']:.4f}", flush=True)
    flat = drive_flat_render("cuda")
    flat_grid = drive_flat_render("cuda", ("grid_sphere_scene", (1024,)), canary=canary)
    # c1's frame: batches of 76,800 rays, below FLAT_SMALL (one ray a thread).
    flat_c1 = drive_flat_render("cuda", ("reference_demo_scene", ()), 320, 240)
    for name, r, size in (("sprint3", flat, (1920, 1080)), ("grid1024", flat_grid, (1920, 1080)),
                          ("c1", flat_c1, (320, 240))):
        check(f"render pallas_flat {name}", r["ok"])
        print(f"main path render(fold='pallas_flat') {name} {size[0]}x{size[1]} d3: "
              f"launches={r['launches']} rays_a_thread={cuda_hit.flat_rays(size[0] * size[1])} "
              f"ok={r['ok']} plain_calls_on_cuda={r['plain_calls']} "
              f"image={r['image']} equal_to_default_frac={r['equal_frac']} "
              f"pixels_differing_past_1e-5={r['differ']} "
              + (f"(outside the canary's {r['canary_lanes']} differing lanes: "
                 f"{r['differ_outside_canary']}) " if "canary_lanes" in r else "")
              + f"max_abs_err={r['max_abs_err']:.3g} "
              f"frame_ms pallas_flat={r['frame_ms_pallas_flat']:.4f} "
              f"default={r['frame_ms_auto']:.4f}", flush=True)
    loop = drive_hit_loop("cuda")
    check("per-level loop", loop["ok"])
    print(f"main path per-level loop (closest_hit_soa, _ShortlistHit) grid1024 1920x1080 d3: "
          f"launches={loop['launches']} ok={loop['ok']} plain_calls_on_cuda={loop['plain_calls']} "
          f"image={loop['image']} equal_to_default_frac={loop['equal_frac']} "
          f"gradient: launches={loop['grad_launches_loop']} (default route "
          f"{loop['grad_launches_default']}) loss={loop['loss_loop']:.6g} (default "
          f"{loop['loss_default']:.6g}) rel_err={ {k: float(f'{v:.3g}') for k, v in loop['grad_rel_err'].items()} } "
          f"max|grad|={ {k: float(f'{v:.3g}') for k, v in loop['grad_scale'].items()} } "
          f"frame_ms loop={loop['frame_ms_loop']:.4f} default={loop['frame_ms_default']:.4f}",
          flush=True)

    guards = check_guards("cuda")
    for name, passed in guards.items():
        check(f"guard {name}", passed)
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
                             "fit_10_steps": train["launches"]["trace_whole"],
                             "app_fit_c4_600_steps": app["fit"]["launches"]["trace_whole"],
                             "app_render_c3": app["cli"]["render_c3"]["launches"]["trace_whole"]},
        "max_abs_err": max(r["max_abs_err"] for r in results),
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "ms_emit_res": main["ms_res"], "bound_emit_res_ms": main["bound_res_ms"],
        "ms_by_case": {r["name"]: r["ms"] for r in results},
        "ms_emit_res_by_case": {r["name"]: r["ms_res"] for r in results},
        "bound_ms_by_case": {r["name"]: r["bound_ms"] for r in results},
        "bound_emit_res_ms_by_case": {r["name"]: r["bound_res_ms"] for r in results},
        "route_1920x1080_d3": {r["name"]: {
            "n_c": r["n_c"], "whole_ms": r["whole_ms"],
            "per_level_kernels_ms": r["kernels"]["sum_ms"], "whole_call_ms": r["whole_call_ms"],
            "per_level_call_ms": r["levels_call_ms"]} for r in route},
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
        "ms_by_case": {b["name"]: b["ms"] for b in bwd_results},
        "bound_ms_by_case": {b["name"]: b["bound_ms"] for b in bwd_results},
        "route_1920x1080_d3": {r["name"]: {
            "n_c": r["n_c"], "whole_ms": r["whole_bwd_ms"],
            "per_level_kernels_ms": r["levels_bwd_kernels_ms"],
            "whole_call_ms": r["whole_bwd_call_ms"],
            "per_level_call_ms": r["levels_bwd_call_ms"]} for r in route},
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
    }, {
        "name": "soft_level", "route": "cuda",
        "source": "raytracer_tpu_torch/csrc/soft_level.cu",
        "replaces": "raytracer_tpu/ops/pallas_soft.py:671",
        "launches": sfit["launches"]["soft_level"],
        "launches_by_path": {"render_soft_c4": srender["launches"]["soft_level"],
                             "soft_fit_c4_20_steps": sfit["launches"]["soft_level"],
                             "app_fit_c4_600_steps": app["fit"]["launches"]["soft_level"]},
        "max_abs_err": max(max(r["fwd_err"]) for r in soft_results),
        "ms": frame_sum(smain["ms"]), "ms_per_level": smain["ms"],
        "ms_per_level_1080p": {k: v["fwd_ms"] for k, v in sdiag["scenes"].items()},
        "bound_ms_per_level_1080p": {k: v["bound_ms"] for k, v in sdiag["scenes"].items()},
        "launches_large_soft_fits": {f"grid{n}_4_steps": f["launches"] for n, f in fits_n.items()},
        "ms_emit_res": frame_sum(smain["ms_res"]),
        "plain_ms": frame_sum(smain["plain_ms"]),
        "bound_ms": frame_sum(smain["bound_ms"]), "bound_by": smain["bound_by"][0],
        "library_ms": None,
        "check": all(r["fwd_ok"] and all(r["order_identical"]) for r in soft_results),
    }, {
        "name": "soft_level_bwd", "route": "cuda",
        "source": "raytracer_tpu_torch/csrc/soft_level_bwd.cu",
        "replaces": "raytracer_tpu/ops/pallas_soft.py:745",
        "launches": sfit["launches"]["soft_level_bwd"],
        "launches_by_path": {"render_soft_c4": srender["launches"]["soft_level_bwd"],
                             "soft_fit_c4_20_steps": sfit["launches"]["soft_level_bwd"],
                             "app_fit_c4_600_steps": app["fit"]["launches"]["soft_level_bwd"]},
        "max_abs_err": smain["table_err"],
        "max_rel_err_all_cases": max(max(max(r["bwd_rel"]), r["table_rel"])
                                     for r in soft_results),
        "ms": frame_sum(smain["bwd_ms"]), "ms_per_level": smain["bwd_ms"],
        "ms_per_level_1080p": {k: v["bwd_ms"] for k, v in sdiag["scenes"].items()},
        "bound_ms_per_level_1080p": {k: v["bwd_bound_ms"] for k, v in sdiag["scenes"].items()},
        "launches_large_soft_fits": {f"grid{n}_4_steps": f["launches"] for n, f in fits_n.items()},
        "plain_ms": frame_sum(smain["bwd_plain_ms"]),
        "bound_ms": frame_sum(smain["bwd_bound_ms"]), "bound_by": smain["bwd_bound_by"][0],
        "library_ms": None,
        "check": all(r["bwd_ok"] and r["order_ok"] for r in soft_results),
    }]
    d1080, c1_depth = depth_paths["grid1024_1920x1080"], depth_paths["c1_demo_320x240"]
    t_flat = hit_times["sprint3_1920x1080"]["fold_flat"]
    t_sl = hit_times["c1_demo_320x240"]["fold_shortlist"]
    t_rec = hit_times["grid1024_1920x1080"]["fold_shortlist_hit"]
    hit_paths = {"render_depth_c1": c1_depth["launches"],
                 "app_render_c1_depth_only": app["cli"]["render_c1_depth"]["launches"],
                 "render_depth_grid1024": d1080["launches"],
                 "render_depth_c5": depth_paths["c5_grid1024_3840x2160"]["launches"],
                 "render_pallas_flat_sprint3": flat["launches"],
                 "render_pallas_flat_grid1024": flat_grid["launches"],
                 "render_pallas_flat_c1": flat_c1["launches"],
                 "loop_grid1024": loop["launches"],
                 "fold_pass_c1": fold_passes["c1_demo_320x240"]["launches"],
                 "fold_pass_grid1024": fold_passes["grid1024_1920x1080"]["launches"]}
    g_flat, l_flat = (fdiag["scenes"][k] for k in ("grid1024_1920x1080",
                                                   "loop_grid1024_1920x1080_d3"))
    flat_extra = {
        "ms_grid1024_1920x1080": g_flat["ms"][0], "bound_ms_grid1024_1920x1080":
        g_flat["bound_ms"][0], "issue_floor_ms_grid1024_1920x1080": g_flat["issue_floor_ms"][0],
        "ms_loop_grid1024_by_level": l_flat["ms"], "bound_ms_loop_grid1024_by_level":
        l_flat["bound_ms"], "ms_flat_diagnosis": {k: v["ms"] for k, v in fdiag["scenes"].items()},
        "sm_clock_mhz": fdiag["clocks"], "smem_grid1024": g_flat["smem"],
        "frame_ms_pallas_flat": {"sprint3": flat["frame_ms_pallas_flat"],
                                 "grid1024": flat_grid["frame_ms_pallas_flat"],
                                 "c1": flat_c1["frame_ms_pallas_flat"]},
    }
    for name, source, line, t, where in (
            ("fold_flat", "fold_flat.cu", 181, t_flat, "sprint3_1920x1080"),
            ("fold_shortlist", "fold_shortlist.cu", 1000, t_sl, "c1_demo_320x240"),
            ("fold_shortlist_hit", "fold_shortlist.cu", 1370, t_rec, "grid1024_1920x1080")):
        by_path = {k: v[name] for k, v in hit_paths.items() if v[name]}
        timed = [v[name] for v in hit_times.values()] + [lv[name] for lv in hit_loop
                                                         if name in lv]
        kernels.append({
            "name": name, "route": "cuda", "source": f"raytracer_tpu_torch/csrc/{source}",
            "replaces": f"raytracer_tpu/ops/pallas_fold.py:{line}",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max([r[{"fold_flat": "flat_err", "fold_shortlist": "shortlist_err",
                                   "fold_shortlist_hit": "record_err"}[name]]
                                for r in hit_results] + [v["max_abs_err"] for v in timed]),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "timed_on": where,
            "ms_by_frame": {k: v[name]["ms"] for k, v in hit_times.items()},
            "bound_ms_by_frame": {k: v[name]["bound_ms"] for k, v in hit_times.items()},
            **({"ms_loop_grid1024_by_level": [lv[name]["ms"] for lv in hit_loop],
                "bound_ms_loop_grid1024_by_level": [lv[name]["bound_ms"] for lv in hit_loop]}
               if name != "fold_flat" else flat_extra),
            "library_ms": None,
            "check": (all(r["ok"] for r in hit_results) and all(v["same"] for v in timed)
                      and (name != "fold_flat" or (not flat_failed(fdiag) and fplan))),
        })
    # The sharded paths' launches (per rank on the two-rank meshes).
    one, two = dist_r["one_rank"], dist_r["two_ranks"][0]
    dist_paths = {
        "sharded_c5_1x1": one["c5"]["launches"],
        "cli_render_c5_mesh_1x1": one["cli_c5"]["launches"],
        "sharded_sprint3_1x1": one["sprint3"]["launches"],
        "sharded_soft_fit_c4_1x1_3_steps": {
            k: sum(p[k] for p in one["c4_fit"]["launches_per_step"]) for k in launches_of()},
        "sharded_grid1024_2x1_a_rank": two["px_2x1"]["launches"],
        "sharded_grid1024_1x2_a_rank": two["prim_1x2"]["launches"],
        **{f"fit_step_2x1_{k}_a_rank": v["launches_per_step"]
           for k, v in two["fits_2x1"].items()},
    }
    for k in kernels:
        k["launches_by_path"].update(
            {path: v[k["name"]] for path, v in dist_paths.items() if v[k["name"]]})
    print(json.dumps({"kernels": kernels}), flush=True)
    if failed:
        print(f"chip_smoke: {len(failed)} check(s) failed: {'; '.join(failed)}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    argv = sys.argv[1:]
    if "--root" in argv:
        sys.path.insert(0, argv[argv.index("--root") + 1])
    if "--dist-only" in argv:
        sys.exit(dist_only())
    if "--bounce-only" in argv:
        sys.exit(bounce_only())
    for mode in COMPARE_MODES:
        if f"--{mode}-compare" in argv:
            sys.exit(compare(mode, argv[argv.index(f"--{mode}-compare") + 1],
                             argv[argv.index("--out") + 1] if "--out" in argv else None))
        if f"--{mode}-only" in argv:
            sys.exit(only(mode))
    sys.exit(main())
