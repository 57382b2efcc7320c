"""The per-level chain: scenes and depths outside the whole-trace kernels'
class, one bounce level per launch.

For scenes outside the whole-trace kernels' class (more than
``FUSED_MAX_CHUNKS`` sphere chunks, a table too large for the default
shared memory, as the 1024-sphere grid's is, or depths above
``FUSED_MAX_DEPTH``), ``trace_soa`` runs ``trace_levels``: per frame one
launch of csrc/ray_stats.cu (``ray_stats``: the reach statistics of each
tile of level-0 rays), then for each level ``phase_a`` (plain PyTorch on the
device: each tile's near-to-far chunk shortlist from its stats) and one
launch of csrc/trace_level.cu (``trace_level``: the fold over the tile's
shortlist with per-lane chunk gates, the shading and the bounce, and the
next level's tile stats). Its backward, ``trace_levels_bwd``, launches
csrc/trace_level_bwd.cu (``trace_level_bwd``) for k = depth..0.

A tile is ``tile`` = (rows, cols) pixels of the frame's ``[H, W]`` planes,
one CUDA block of 256 threads (``LEVEL_TILE`` by default; a one-row batch
uses (1, 256)); tiles are numbered row-major, and a partial tile at the
frame's ragged edge counts only its real lanes. One tiling serves every
level, so a bounce level's shortlists come from the stats the previous
level's kernel wrote. A tile's stats row has ``NSTAT + n_c`` floats: the box
of its used lanes' segments inside the sphere slab (lo xyz, hi xyz; raw:
``phase_a`` adds ``_AABB_PAD``), the sums of their segment starts (xyz),
the used-lane count, whether any lane is alive, then one 0/1 per chunk:
whether any used lane's segment reaches the chunk's gate. A lane is used
when it is alive (throughput > 0) and meets the slab. Scenes of fewer than
``_PER_TILE_MIN_CHUNKS`` chunks walk every chunk in index order (identity
lists) and need no stats.

Every kernel has its plain PyTorch version here (``ray_stats_reference``,
``trace_level_reference``, and ``trace_level_bwd_reference``, which
ops/cuda_fold.py's whole-trace backward reference shares), which the
wrapper runs for CPU tensors; for CUDA tensors it launches the kernel or
raises. Each wrapper counts its launches (``profiler.count_launch``). The
chain gives the same selections as the whole-trace kernel: the shortlists are
conservative (a padded segment box, and a reach union without the best t),
the gates per lane are the same, and the fold breaks ties on the global
index, so the order of a list does not change the result.
"""

from __future__ import annotations

import ctypes

import torch

from raytracer_tpu_torch.core.v3 import V3
from raytracer_tpu_torch.ops import _build
from raytracer_tpu_torch.ops.cuda_fold import (
    _AABB_PAD,
    _LANE_LS_MAX,
    GATE_AABB,
    FusedTables,
    Residuals,
    _attr_columns,
    _check_planes,
    _check_table,
    _fold,
    _gather,
    _kinds,
    _level,
    _level_math,
    _ls_vector,
    _raise_on,
    _slab_segment,
    _chunk_gate,
    _srecip,
    trace_level_bwd_reference,
)
from raytracer_tpu_torch.ops.trace import MISS_T
from raytracer_tpu_torch.utils import profiler

__all__ = [
    "LEVEL_TILE",
    "NSTAT",
    "tile_grid",
    "ray_stats_reference",
    "ray_stats",
    "phase_a",
    "trace_level_reference",
    "lane_slots",
    "warp_cull_reference",
    "pair_fold",
    "pair_fold_reference",
    "PAIR_MIN_LANES",
    "PAIR_MIN_UNROLL",
    "trace_level",
    "trace_levels",
    "trace_level_bwd_reference",
    "trace_level_bwd",
    "level_smem_bytes",
    "level_bwd_smem_bytes",
    "trace_levels_bwd",
]

# Pixels of a tile, (rows, cols): one block of the kernels (rows * cols =
# _BLOCK). Picked by chip_smoke.py's sweep on the H100 (PERF.md).
LEVEL_TILE = (16, 16)
NSTAT = 11  # stats per tile before the per-chunk reach flags (csrc NSTAT)
_BLOCK = 256  # threads of a block of every per-level kernel (csrc BLOCK)
# Below this many chunks a shortlist cannot beat walking every chunk behind
# the per-lane gates; the JAX package's _PER_TILE_MIN_CHUNKS.
_PER_TILE_MIN_CHUNKS = 3
_BIG = 1e30
# The stats' per-warp chunk cull (``warp_cull_reference``, csrc
# trace_common.cuh): the margin, relative to the largest magnitude in play
# and absolute, and the least largest direction component of a culled lane.
CULL_REL, CULL_ABS, CULL_MIN_DIR = 1e-5, 1e-30, 1e-3
# A listed chunk whose gate fewer than this many lanes of a warp pass is
# folded by the whole warp, one lane's ray at a time (``pair_fold``; csrc
# trace_common.cuh's K_PAIR, which trace_level.cu and fold_shortlist.cu
# share). Picked by measurement on the H100 (PERF.md).
PAIR_MIN_LANES = 8
# Chunks of fewer spheres than this are folded lane by lane whatever the
# warp's count (csrc trace_common.cuh's PAIR_MIN_UNROLL; by measurement).
PAIR_MIN_UNROLL = 2


def uses_shortlists(tables: FusedTables) -> bool:
    """Whether the chain builds per-tile shortlists for this scene (else
    every tile walks all chunks in index order)."""
    return tables.counts["n_c"] >= _PER_TILE_MIN_CHUNKS


def tile_grid(shape, tile=None) -> tuple:
    """``(tile, tiles_h, tiles_w)`` for ``[H, W]`` planes: the tile shape
    (``LEVEL_TILE``, or (1, 256) for a one-row batch) and the tile counts."""
    h, w = shape
    if tile is None:
        tile = LEVEL_TILE if h > 1 else (1, _BLOCK)
    tr, tc = tile
    return (tr, tc), -(-h // tr), -(-w // tc)


def _tile_index(shape, tile, device) -> torch.Tensor:
    """Each lane's tile number, ``[H, W]`` int64."""
    (tr, tc), _, tw = tile_grid(shape, tile)
    h, w = shape
    ty = torch.arange(h, device=device) // tr
    tx = torch.arange(w, device=device) // tc
    return ty[:, None] * tw + tx[None, :]


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def ray_stats_reference(tables: FusedTables, o: V3, d: V3, w: torch.Tensor,
                        tile=None) -> torch.Tensor:
    """Plain version of ``ray_stats``: each tile's stats row,
    ``[tiles, NSTAT + n_c]`` (module docstring). The sums are taken in
    float32 in PyTorch's order, which may differ from the kernel's in the
    last bits; the boxes, counts, flags and reach bits are exact."""
    return _ray_stats(tables, o, d, w, tile)


def _ray_stats(tables: FusedTables, o: V3, d: V3, w: torch.Tensor, tile, cull=None):
    """``ray_stats_reference``; with ``cull`` (``[warps, n_c]`` bool, the
    kernels' warps in ``lane_slots`` order) a lane's chunk gate counts only
    where its warp's cull passes the chunk."""
    t, counts = tables.cols, tables.counts
    (tr, tc), th, tw = tile_grid(w.shape, tile)
    h, wd = w.shape
    iv = (_srecip(d.x), _srecip(d.y), _srecip(d.z))
    t0, t_ex, seg_ok = _slab_segment(t, o, iv)
    alive = w > 0.0
    used = alive & seg_ok
    p1 = [oc + t0 * dc for oc, dc in zip(o, d)]
    p2 = [oc + t_ex * dc for oc, dc in zip(o, d)]
    big = torch.full_like(w, _BIG)
    planes = (
        [torch.where(used, torch.minimum(a, b), big) for a, b in zip(p1, p2)]
        + [torch.where(used, torch.maximum(a, b), -big) for a, b in zip(p1, p2)]
        + [torch.where(used, a, 0.0) for a in p1]
        + [used.float(), alive.float()]
    )
    if counts["n_c"]:
        oo = o.x * o.x + o.y * o.y + o.z * o.z
        do = d.x * o.x + d.y * o.y + d.z * o.z
        warp = None if cull is None else lane_slots(w.shape, tile, w.device)[2]
        for c in range(counts["n_c"]):
            reach = used & _chunk_gate(t, counts["gate"], c, o, d, iv, oo, do, t0, t_ex)
            if cull is not None:
                reach = reach & cull[warp, c]
            planes.append(reach.float())
    fills = [_BIG] * 3 + [-_BIG] * 3 + [0.0] * (len(planes) - 6)
    x = torch.stack([
        torch.nn.functional.pad(p, (0, tw * tc - wd, 0, th * tr - h), value=f)
        for p, f in zip(planes, fills)
    ])
    x = x.reshape(len(planes), th, tr, tw, tc).permute(1, 3, 0, 2, 4)
    x = x.reshape(th * tw, len(planes), tr * tc)
    return torch.cat([
        x[:, 0:3].amin(dim=-1), x[:, 3:6].amax(dim=-1), x[:, 6:10].sum(dim=-1),
        x[:, 10:].amax(dim=-1),
    ], dim=1).contiguous()


def lane_slots(shape, tile=None, device=None):
    """Where the per-level kernels run each lane of ``[H, W]`` planes:
    ``(tile, thread, warp)``, each ``[H, W]`` int64. A tile is one block,
    its thread ``(y % rows) * cols + x % cols``, its warps 32 consecutive
    threads, numbered ``tile * 8 + thread // 32`` over the whole frame."""
    (tr, tc), _, _ = tile_grid(shape, tile)
    h, w = shape
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    tid = _tile_index(shape, tile, device)
    thread = (ys % tr) * tc + xs % tc
    return tid, thread, tid * (_BLOCK // 32) + thread // 32


def warp_cull_reference(tables: FusedTables, o: V3, d: V3, w: torch.Tensor, tile=None):
    """Plain mirror of the per-warp chunk cull of the kernels' stats
    (trace_common.cuh's ``tile_stats`` and ``cull_meets``): ``(stats,
    cull)``, the stats rows
    with each lane's chunk gate taken only where its warp's cull passes the
    chunk, and the cull, ``[warps, n_c]`` bool (``lane_slots`` order).

    A warp's used lanes' segment box (the stats' box, per warp) meets a
    chunk's box grown by ``CULL_REL`` of the largest magnitude among the
    two boxes, the lanes' origins and the slab, plus ``CULL_ABS``. Float32
    rounding of a gate moves its crossing points by a few ulps of those
    magnitudes, so a chunk whose gate some lane passes always meets the
    grown box: the stats equal ``ray_stats_reference``'s bit for bit. A
    warp with a used lane whose origin or segment ends are not finite, or
    whose direction has no component of magnitude ``CULL_MIN_DIR`` (the
    safe reciprocal clamps it, and the gate's ray leaves the segment box),
    passes every chunk; the sphere gate (``GATE_SPHERE``) passes every
    chunk too. Only the box gate is culled.
    """
    t, counts = tables.cols, tables.counts
    n_c = counts["n_c"]
    _, _, warp = lane_slots(w.shape, tile, w.device)
    n_warps = int(warp.max()) + 1
    iv = (_srecip(d.x), _srecip(d.y), _srecip(d.z))
    t0, t_ex, seg_ok = _slab_segment(t, o, iv)
    used = ((w > 0.0) & seg_ok).reshape(-1)
    wid = warp.reshape(-1)[used]
    p1 = [(oc + t0 * dc).reshape(-1)[used] for oc, dc in zip(o, d)]
    p2 = [(oc + t_ex * dc).reshape(-1)[used] for oc, dc in zip(o, d)]
    oc = [x.reshape(-1)[used] for x in o]
    dc = [x.reshape(-1)[used] for x in d]

    def per_warp(x, reduce, fill):
        out = torch.full((n_warps,), fill, dtype=x.dtype, device=x.device)
        return out.scatter_reduce(0, wid, x, reduce=reduce, include_self=True)

    lo = [per_warp(torch.minimum(a, b), "amin", _BIG) for a, b in zip(p1, p2)]
    hi = [per_warp(torch.maximum(a, b), "amax", -_BIG) for a, b in zip(p1, p2)]
    mags = torch.stack([x.abs() for x in (*oc, *p1, *p2)]).amax(dim=0)
    finite = torch.stack([torch.isfinite(x) for x in (*oc, *p1, *p2)]).all(dim=0)
    dmax = torch.stack([x.abs() for x in dc]).amax(dim=0)
    bad = (~finite | ~(dmax >= CULL_MIN_DIR)).to(torch.int32)
    scale = per_warp(torch.where(finite, mags, 0.0), "amax", 0.0)
    slab = torch.cat([t[f"slab_{s}_{x}"] for s in ("lo", "hi") for x in "xyz"]).abs().amax()
    scale = torch.maximum(scale, slab)
    off = per_warp(bad, "amax", 0) > 0
    any_used = per_warp(torch.ones_like(wid, dtype=torch.int32), "amax", 0) > 0
    c_lo, c_hi = t["c_lo"], t["c_hi"]  # [3, n_c]
    c_mag = torch.maximum(c_lo.abs().amax(dim=0), c_hi.abs().amax(dim=0))
    margin = CULL_REL * torch.maximum(scale[:, None], c_mag[None, :]) + CULL_ABS
    meet = torch.ones((n_warps, n_c), dtype=torch.bool, device=w.device)
    for k in range(3):
        meet &= (c_lo[k][None, :] - margin <= hi[k][:, None])
        meet &= (c_hi[k][None, :] + margin >= lo[k][:, None])
    if counts["gate"] != GATE_AABB:
        meet = torch.ones_like(meet)
    cull = any_used[:, None] & (meet | off[:, None])
    return _ray_stats(tables, o, d, w, tile, cull), cull


def phase_a(stats: torch.Tensor, tables: FusedTables):
    """Each tile's chunk shortlist from its stats: ``(chunk_list [tiles,
    n_c] int32, counts [tiles] int32)``.

    The counterpart of the JAX package's ``_phase_a_from_stats`` (with
    ``_stats_to_phase_a`` and ``_stats_to_chunk_reach``): a chunk is
    accepted when its box overlaps the tile's segment box (padded by
    ``_AABB_PAD``, here and nowhere else) and some used lane reaches it;
    the list holds the chunks sorted by the distance from the tile's
    segment-start centroid to their bounding sphere, accepted first (a
    stable sort), and ``counts`` the accepted number, or -1 for a tile with
    no alive lane. Plain PyTorch on the stats' device, with no host sync.
    """
    with profiler.span("rt.phase_a"):
        cols = tables.cols
        lo = stats[:, 0:3, None] - _AABB_PAD
        hi = stats[:, 3:6, None] + _AABB_PAD
        accept = ((cols["c_lo"] <= hi) & (cols["c_hi"] >= lo)).all(dim=1)
        accept = accept & (stats[:, NSTAT:] > 0.0)
        cen = stats[:, 6:9, None] / torch.clamp_min(stats[:, 9:10, None], 1.0)
        g = cols["c_g"]
        dist = torch.sqrt(
            (cen[:, 0] - g[0]) ** 2 + (cen[:, 1] - g[1]) ** 2 + (cen[:, 2] - g[2]) ** 2
        ) - cols["gr"]
        order = torch.argsort(torch.where(accept, dist, _BIG), dim=1, stable=True)
        counts = torch.where(stats[:, 10] > 0.0, accept.sum(dim=1), -1)
        return order.to(torch.int32), counts.to(torch.int32)


def trace_level_reference(tables: FusedTables, shortlist, o: V3, d: V3, w: torch.Tensor,
                          acc: V3, is_last: bool, tile=None, want_stats: bool = False):
    """Plain version of ``trace_level``: one level over the shortlists.

    ``shortlist`` is ``phase_a``'s ``(chunk_list, counts)``, or ``None``
    for identity lists. Each alive lane folds walls and boxes, then its
    tile's listed chunks in list order, each behind the lane's gate (the
    whole-trace fold restricted to the list), then regathers, shades and
    bounces. Returns ``(t, index, acc, w_next, o_next V3, d_next V3,
    stats)``: dead lanes (``w == 0``) get ``(MISS_T, -1)`` and keep their
    ray, throughput and accumulator; ``stats`` is the next level's
    ``ray_stats_reference`` with ``want_stats``, else ``None``.
    """
    t_k, i_k, inc, w_n, o_n, d_n = _level(
        tables.cols, tables.counts, o, d, w, is_last, _lane_lists(shortlist, w, tile)
    )
    return _finish_level(tables, o, d, w, acc, tile, want_stats, t_k, i_k, inc, w_n, o_n, d_n)


def _lane_lists(shortlist, w: torch.Tensor, tile):
    """Each lane's tile's ``(chunk order [..., n_c], length)``, or None."""
    if shortlist is None:
        return None
    chunk_list, counts = shortlist
    tid = _tile_index(w.shape, tile, w.device)
    return chunk_list.long()[tid], counts[tid]


def _finish_level(tables, o, d, w, acc, tile, want_stats, t_k, i_k, inc, w_n, o_n, d_n):
    """``trace_level_reference``'s outputs from a level's unmasked ones."""
    alive = w > 0.0
    zero = torch.zeros_like(w)
    acc = acc + V3.where(alive, inc, V3(zero, zero, zero))
    w_next = torch.where(alive, w_n, w)
    o_next, d_next = V3.where(alive, o_n, o), V3.where(alive, d_n, d)
    stats = (ray_stats_reference(tables, o_next, d_next, w_next, tile)
             if want_stats else None)
    return (torch.where(alive, t_k, MISS_T), torch.where(alive, i_k, -1), acc,
            w_next, o_next, d_next, stats)


def _sphere_t(t: dict, gi: torch.Tensor, o: V3, d: V3, oo, do):
    """Each lane's near root at sphere ``gi`` (a per-lane index tensor), op
    for op ``_fold``'s (NaN on a miss)."""
    cx, cy, cz, cr2 = (t[n][gi] for n in ("cx", "cy", "cz", "cr2"))
    s = d.x * cx + d.y * cy + d.z * cz
    m = o.x * cx + o.y * cy + o.z * cz
    b_half = do - s
    c_full = oo - 2.0 * m + cr2
    disc = b_half * b_half - c_full
    return -b_half - torch.sqrt(disc)


def pair_fold(tables: FusedTables, shortlist, o: V3, d: V3, w: torch.Tensor,
              k_min: int = PAIR_MIN_LANES, tile=None):
    """Plain mirror of the warp-cooperative fold of a shortlist (csrc
    trace_common.cuh's ``fold_list``, which trace_level.cu and
    fold_shortlist.cu run): each lane's ``(bt, bi)`` over the walls, the
    boxes and its tile's listed chunks, and a dict of the fold's work by
    route. The walls and boxes are folded on every lane, dead or not; the
    spheres only on the lanes alive under ``w`` that meet the slab.

    The kernel's warps (``lane_slots``) walk their tile's list in order.
    At each listed chunk a lane's gate reads its own best t so far. Where
    at least ``k_min`` lanes of the warp pass it, or the scene's chunks
    hold fewer than ``PAIR_MIN_UNROLL`` spheres, each of them folds the
    chunk's spheres in index order (ties to the lower index); where fewer
    pass, the warp takes those lanes one at a time (two at a time for
    chunks of at most 16 spheres), each of its lanes computes one sphere's
    t of that lane's ray, and the lexicographic minimum of (t, index) over
    t > 0 is merged into the lane's best under the same tie rule. Both give
    the lexicographic minimum, so the fold does not depend on the route.

    The dict: ``lane_chunks`` (gate passes summed over lanes: the chunks a
    lane folds), ``warp_chunks`` (chunks a warp folds: its union),
    ``per_lane`` (warp chunks folded lane by lane), ``pair`` (warp chunks
    folded cooperatively) and ``pair_steps`` (the warp steps those take),
    ``used`` (lanes that fold spheres), ``warps`` (warps with one) and
    ``pass_hist`` (the warp chunks by how many of their lanes pass, 0-32).
    """
    t, counts = tables.cols, tables.counts
    n_s, unroll, n_c = counts["n_s"], counts["unroll"], counts["n_c"]
    if unroll < PAIR_MIN_UNROLL:
        k_min = 1  # every chunk lane by lane
    work = dict(lane_chunks=0, warp_chunks=0, per_lane=0, pair=0, pair_steps=0, used=0,
                warps=0, pass_hist=[0] * 33)
    bt, bi = _fold(t, {**counts, "n_c": 0}, o, d)  # walls and boxes
    if not n_s:
        return bt, bi, work
    lists = _lane_lists(shortlist, w, tile)
    if lists is None:
        pos = torch.arange(n_c, dtype=torch.long, device=w.device)
        lists = (pos.expand(*w.shape, n_c), torch.full_like(bi, n_c))
    _, _, warp = lane_slots(w.shape, tile, w.device)
    n_warps = int(warp.max()) + 1
    iv = (_srecip(d.x), _srecip(d.y), _srecip(d.z))
    t0, t_ex, seg_ok = _slab_segment(t, o, iv)
    oo = o.x * o.x + o.y * o.y + o.z * o.z
    do = d.x * o.x + d.y * o.y + d.z * o.z
    seg_ok = seg_ok & (w > 0.0)
    work["used"] = int(seg_ok.sum())
    work["warps"] = int((torch.bincount(warp[seg_ok], minlength=n_warps) > 0).sum())
    two = 2 if unroll <= 16 else 1
    for k in range(n_c):
        listed = seg_ok & (k < lists[1])
        if not bool(listed.any()):
            continue
        c = lists[0][..., k]
        gate = listed & _chunk_gate(t, counts["gate"], c, o, d, iv, oo, do, t0,
                                    torch.minimum(t_ex, bt))
        n_pass = torch.bincount(warp[gate], minlength=n_warps)
        lane_route = gate & (n_pass[warp] >= k_min)
        pair_route = gate & ~lane_route
        n_pair = n_pass * (n_pass < k_min)
        work["lane_chunks"] += int(gate.sum())
        work["warp_chunks"] += int((n_pass > 0).sum())
        work["per_lane"] += int((n_pass >= k_min).sum())
        work["pair"] += int((n_pair > 0).sum())
        work["pair_steps"] += int(((n_pair + two - 1) // two).sum())
        hist = torch.bincount(n_pass[n_pass > 0], minlength=33).tolist()
        work["pass_hist"] = [a + b for a, b in zip(work["pass_hist"], hist)]
        # Per lane: the chunk's spheres in index order.
        lt, li = bt, bi
        pt = torch.full_like(bt, float("inf"))
        pi = torch.full_like(bi, 2 ** 31 - 1)
        for j in range(unroll):
            gi = c * unroll + j
            real = gi < n_s
            gi32 = gi.to(torch.int32)
            tt = _sphere_t(t, gi.clamp_max(n_s - 1), o, d, oo, do)
            take = real & (tt > 0.0) & ((tt < lt) | ((tt == lt) & (gi32 < li)))
            lt, li = torch.where(take, tt, lt), torch.where(take, gi32, li)
            # Cooperatively: the lexicographic minimum over t > 0.
            cand = real & (tt > 0.0) & ((tt < pt) | ((tt == pt) & (gi32 < pi)))
            pt, pi = torch.where(cand, tt, pt), torch.where(cand, gi32, pi)
        merge = pair_route & ((pt < bt) | ((pt == bt) & (pi < bi)))
        bt = torch.where(lane_route, lt, torch.where(merge, pt, bt))
        bi = torch.where(lane_route, li, torch.where(merge, pi, bi))
    return bt, bi, work


def pair_fold_reference(tables: FusedTables, shortlist, o: V3, d: V3, w: torch.Tensor,
                        acc: V3, is_last: bool, k_min: int = PAIR_MIN_LANES, tile=None,
                        want_stats: bool = False):
    """Plain mirror of ``trace_level`` with its warp-cooperative fold
    (``pair_fold``): the outputs of ``trace_level_reference`` (equal to
    them bit for bit), and ``pair_fold``'s dict of the fold's work by
    route."""
    t, counts = tables.cols, tables.counts
    bt, bi, work = pair_fold(tables, shortlist, o, d, w, k_min, tile)
    hit = bt < MISS_T
    attrs = _gather(_attr_columns(t, counts), bi, hit)
    t_k, inc, w_n, o_n, d_n = _level_math(attrs, o, d, w, bt, hit, *_kinds(bi, hit, counts),
                                          _ls_vector(t), counts, is_last)
    out = _finish_level(tables, o, d, w, acc, tile, want_stats, t_k, bi, inc, w_n, o_n, d_n)
    return out, work


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------


def _table_args(tables: FusedTables) -> tuple:
    c = tables.counts
    return (
        tables.packed.data_ptr(), tables.packed.numel(),
        c["n_s"], c["unroll"], c["n_w"], c["n_b"], c["n_pt"], c["n_sun"], c["gate"],
    )


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _ptrs(planes) -> tuple:
    return tuple(None if p is None else p.data_ptr() for p in planes)


def _check_grid(shape, name: str):
    if len(shape) != 2:
        raise ValueError(f"{name} takes [H, W] planes, got {tuple(shape)}")


def ray_stats(tables: FusedTables, o: V3, d: V3, w: torch.Tensor, tile=None) -> torch.Tensor:
    """The stats of each tile of these rays, ``[tiles, NSTAT + n_c]``
    float32 (module docstring). On CPU tensors this is
    ``ray_stats_reference``; on CUDA tensors it launches csrc/ray_stats.cu
    on the current stream, or raises."""
    dev, shape = w.device, w.shape
    _check_planes((*o, *d, w), shape, dev, "ray_stats")
    _check_grid(shape, "ray_stats")
    if not tables.counts["n_c"]:
        raise ValueError("ray_stats needs a scene with spheres")
    if dev.type == "cpu":
        return ray_stats_reference(tables, o, d, w, tile)
    _check_table(tables, 0, dev, "ray_stats")
    return _ray_stats_cuda(tables, o, d, w, tile)


def _ray_stats_cuda(tables, o, d, w, tile):
    shape = w.shape
    (tr, tc), th, tw = tile_grid(shape, tile)
    stats = torch.empty((th * tw, NSTAT + tables.counts["n_c"]), dtype=torch.float32,
                        device=w.device)
    if w.numel():
        lib = _build.load("ray_stats", _SIGNATURES["ray_stats"])
        err = lib.ray_stats_launch(
            *_table_args(tables), *_ptrs((*o, *d, w, stats)), shape[0], shape[1], tr, tc,
            _stream(w.device),
        )
        _raise_on(err, lib, "ray_stats")
        profiler.count_launch("ray_stats")
    return stats


def trace_level(tables: FusedTables, shortlist, o: V3, d: V3, w: torch.Tensor, acc: V3,
                t_out: torch.Tensor, i_out: torch.Tensor, nxt, is_last: bool,
                tile=None, want_stats: bool = False):
    """One level of the chain over the tiles' shortlists.

    Writes the level's t into ``t_out`` and index into ``i_out``, adds its
    increment into the accumulator planes ``acc`` in place, and writes the
    next rays and throughput into ``nxt`` (7 planes: o xyz, d xyz, w; or
    ``None`` to drop them). ``shortlist`` is ``phase_a``'s ``(chunk_list,
    counts)``, or ``None`` for identity lists. Returns the next level's
    tile stats with ``want_stats``, else ``None``. On CPU tensors this runs
    ``trace_level_reference``; on CUDA tensors it launches
    csrc/trace_level.cu on the current stream, or raises.
    """
    dev, shape = w.device, w.shape
    name = "trace_level"
    _check_planes((*o, *d, w, *acc, t_out), shape, dev, name)
    _check_planes((i_out,), shape, dev, name, torch.int32)
    if nxt is not None:
        _check_planes(tuple(nxt), shape, dev, name)
    _check_grid(shape, name)
    if want_stats and (nxt is None or not tables.counts["n_c"]):
        raise ValueError("the next level's stats need its rays and a scene with spheres")
    if shortlist is not None:
        (_, th, tw), n_c = tile_grid(shape, tile), tables.counts["n_c"]
        _check_planes((shortlist[0],), (th * tw, n_c), dev, name, torch.int32)
        _check_planes((shortlist[1],), (th * tw,), dev, name, torch.int32)
    if dev.type == "cpu":
        t_k, i_k, acc_new, w_n, o_n, d_n, stats = trace_level_reference(
            tables, shortlist, o, d, w, acc, is_last, tile, want_stats
        )
        for dst, src in zip((t_out, i_out, *acc), (t_k, i_k, *acc_new)):
            dst.copy_(src)
        if nxt is not None:
            for dst, src in zip(nxt, (*o_n, *d_n, w_n)):
                dst.copy_(src)
        return stats
    _check_table(tables, 0, dev, name)
    return _trace_level_cuda(tables, shortlist, o, d, w, acc, t_out, i_out, nxt, is_last,
                             tile, want_stats)


def _trace_level_cuda(tables, shortlist, o, d, w, acc, t_out, i_out, nxt, is_last, tile,
                      want_stats):
    shape = w.shape
    (tr, tc), th, tw = tile_grid(shape, tile)
    stats = (torch.empty((th * tw, NSTAT + tables.counts["n_c"]), dtype=torch.float32,
                         device=w.device) if want_stats else None)
    if w.numel():
        lib = _build.load("trace_level", _SIGNATURES["trace_level"])
        err = lib.trace_level_launch(
            *_table_args(tables), *_ptrs(shortlist if shortlist is not None else (None, None)),
            *_ptrs((*o, *d, w, *acc, t_out, i_out)),
            *_ptrs(nxt if nxt is not None else (None,) * 7), *_ptrs((stats,)),
            shape[0], shape[1], tr, tc, int(is_last), _stream(w.device),
        )
        _raise_on(err, lib, "trace_level")
        profiler.count_launch("trace_level")
    return stats


def trace_levels(tables: FusedTables, o: V3, d: V3, w: torch.Tensor, depth: int,
                 emit_res: bool = False, tile=None):
    """Every bounce level of a ray tile through the per-level chain: ``(rgb
    V3, t f32[depth+1, ...], index i32[depth+1, ...])``, and with
    ``emit_res`` also ``res`` f32[depth, 7, ...], the input rays and
    throughput of levels 1..depth (``Residuals.res``), as ``trace_whole``
    returns them.

    One ``ray_stats`` (for scenes with shortlists), then per level
    ``phase_a`` and one ``trace_level``; each level writes straight into
    the stacked t, index and residual planes (without ``emit_res``, the
    next rays alternate between two buffers). Nothing waits on the host
    between levels: each kernel reads its tiles' list lengths from device
    memory. Inputs are seven contiguous float32 ``[H, W]`` planes on one
    device, checked once here.
    """
    dev, shape = w.device, w.shape
    _check_planes((*o, *d, w), shape, dev, "trace_levels")
    _check_grid(shape, "trace_levels")
    if depth < 0:
        raise ValueError(f"depth {depth} is negative")
    cuda = dev.type != "cpu"
    if cuda:
        _check_table(tables, depth, dev, "trace_levels")
    stats_fn = _ray_stats_cuda if cuda else ray_stats_reference
    level_fn = _trace_level_cuda if cuda else trace_level
    per_tile = uses_shortlists(tables)
    t_all = torch.empty((depth + 1, *shape), dtype=torch.float32, device=dev)
    i_all = torch.empty((depth + 1, *shape), dtype=torch.int32, device=dev)
    acc = V3(*torch.zeros((3, *shape), dtype=torch.float32, device=dev).unbind(0))
    res = torch.empty((depth if emit_res else min(depth, 2), 7, *shape),
                      dtype=torch.float32, device=dev)
    stats = stats_fn(tables, o, d, w, tile) if per_tile else None
    for k in range(depth + 1):
        last = k == depth
        shortlist = phase_a(stats, tables) if per_tile else None
        nxt = None if last else res[k if emit_res else k % 2].unbind(0)
        stats = level_fn(tables, shortlist, o, d, w, acc, t_all[k], i_all[k], nxt, last,
                         tile, per_tile and not last)
        if not last:
            o, d, w = V3(*nxt[:3]), V3(*nxt[3:6]), nxt[6]
    out = (acc, t_all, i_all)
    return out + (res,) if emit_res else out


def level_smem_bytes(tables: FusedTables, stats: bool) -> int:
    """Dynamic shared bytes of a ``trace_level`` launch: the spheres as
    float4, the rest of the table without its materials, the shortlist
    and, with ``stats``, the stats' scratch (csrc/trace_level.cu)."""
    c = tables.counts
    n_prim = c["n_s"] + c["n_w"] + c["n_b"]
    words = tables.packed.numel() - 8 * n_prim - c["n_s"] + c["n_c"]
    if stats:
        words += 32 * 10 + -(-c["n_c"] // 32)
    return 4 * words


def level_bwd_smem_bytes(tables: FusedTables) -> int:
    """Dynamic shared bytes of a ``trace_level_bwd`` launch: the table
    without its materials, the light and sky sums (each lane's, for at
    most three lights; else one row), and the 14 float32 sums of each wall
    and box row (csrc/trace_level_bwd.cu)."""
    c = tables.counts
    n_ls = 6 * (c["n_pt"] + c["n_sun"]) + 10
    n_prim = c["n_s"] + c["n_w"] + c["n_b"]
    ls = n_ls * _BLOCK if n_ls <= _LANE_LS_MAX else n_ls
    return 4 * (tables.packed.numel() - 8 * n_prim + ls + 14 * (c["n_w"] + c["n_b"]))


def trace_level_bwd(tables: FusedTables, attrs: torch.Tensor, ls: torch.Tensor,
                    o: V3, d: V3, w: torch.Tensor, t_k: torch.Tensor, i_k: torch.Tensor,
                    ct_acc: V3, ct_next, is_last: bool, sums: tuple):
    """The backward of one level: the cotangents of its input rays and
    throughput, ``[ct_o xyz, ct_d xyz, ct_w]``, from the image cotangent
    ``ct_acc`` and ``ct_next``, the cotangents of the level's outputs (the
    same 7 planes of level k+1; ``None`` after the last level). The table
    cotangents are added into ``sums``, float64 tensors of the shapes of
    ``attrs`` and ``ls``. On CPU tensors this is
    ``trace_level_bwd_reference``; on CUDA tensors it launches
    csrc/trace_level_bwd.cu on the current stream, or raises. The kernel
    reads the scene from ``tables.packed``."""
    dev, shape = w.device, w.shape
    name = "trace_level_bwd"
    _check_planes((*o, *d, w, t_k, *ct_acc), shape, dev, name)
    _check_planes((i_k,), shape, dev, name, torch.int32)
    if ct_next is not None:
        _check_planes(tuple(ct_next), shape, dev, name)
    _check_planes((sums[0],), tuple(attrs.shape), dev, name, torch.float64)
    _check_planes((sums[1],), tuple(ls.shape), dev, name, torch.float64)
    if dev.type == "cpu":
        return trace_level_bwd_reference(tables, attrs, ls, o, d, w, t_k, i_k, ct_acc,
                                         ct_next, is_last, sums)
    _check_table(tables, 0, dev, name)
    return _trace_level_bwd_cuda(tables, attrs, ls, o, d, w, t_k, i_k, ct_acc, ct_next,
                                 is_last, sums)


def _trace_level_bwd_cuda(tables, attrs, ls, o, d, w, t_k, i_k, ct_acc, ct_next, is_last,
                          sums):
    cts = torch.empty((7, *w.shape), dtype=torch.float32, device=w.device).unbind(0)
    n = w.numel()
    if n:
        lib = _build.load("trace_level_bwd", _SIGNATURES["trace_level_bwd"])
        err = lib.trace_level_bwd_launch(
            *_table_args(tables), *_ptrs((*o, *d, w, t_k, i_k, *ct_acc)),
            *_ptrs(ct_next if ct_next is not None else (None,) * 7), *_ptrs(cts),
            *_ptrs(sums), n, int(is_last), _stream(w.device),
        )
        _raise_on(err, lib, "trace_level_bwd")
        profiler.count_launch("trace_level_bwd")
    return list(cts)


def trace_levels_bwd(tables: FusedTables, attrs: torch.Tensor, ls: torch.Tensor,
                     levels: Residuals, ct_acc: V3, depth: int):
    """The per-level chain's backward: ``(ct_o V3, ct_d V3, ct_w, ct_attrs
    f32[n_prim, 14], ct_ls)``, as ``trace_whole_bwd`` returns them, from
    ``trace_levels(..., emit_res=True)``'s selections and residuals.
    ``trace_level_bwd`` for k = depth..0, each level's ray cotangents
    feeding level k-1's; the table cotangents of all levels summed in
    float64. The planes are checked once here."""
    dev, shape = levels.w.device, levels.w.shape
    name = "trace_levels_bwd"
    _check_planes((*levels.o, *levels.d, levels.w, *ct_acc), shape, dev, name)
    _check_planes((levels.t,), (depth + 1, *shape), dev, name)
    _check_planes((levels.i,), (depth + 1, *shape), dev, name, torch.int32)
    _check_planes((levels.res,), (depth, 7, *shape), dev, name)
    n_prim = sum(tables.counts[k] for k in ("n_s", "n_w", "n_b"))
    n_ls = 6 * (tables.counts["n_pt"] + tables.counts["n_sun"]) + 10
    _check_planes((attrs,), (n_prim, 14), dev, name)
    _check_planes((ls,), (n_ls,), dev, name)
    cuda = dev.type != "cpu"
    if cuda:
        _check_table(tables, depth, dev, name)
    level_fn = _trace_level_bwd_cuda if cuda else trace_level_bwd_reference
    sums = (torch.zeros(attrs.shape, dtype=torch.float64, device=dev),
            torch.zeros(ls.shape, dtype=torch.float64, device=dev))
    ct = None
    for k in reversed(range(depth + 1)):
        o, d, w = levels.level(k)
        ct = level_fn(tables, attrs, ls, o, d, w, levels.t[k], levels.i[k], ct_acc, ct,
                      k == depth, sums)
    return V3(*ct[:3]), V3(*ct[3:6]), ct[6], sums[0].float(), sums[1].float()


# C signatures of the exported functions of csrc/ray_stats.cu,
# csrc/trace_level.cu and csrc/trace_level_bwd.cu.
_TABLE_ARGTYPES = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_int] * 7
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "ray_stats": {
        "ray_stats_launch": (_I, _TABLE_ARGTYPES + [_P] * 8 + [_I] * 4 + [_P]),
        "ray_stats_error_string": (ctypes.c_char_p, [_I]),
    },
    "trace_level": {
        "trace_level_launch": (_I, _TABLE_ARGTYPES + [_P] * 22 + [_I] * 5 + [_P]),
        "trace_level_error_string": (ctypes.c_char_p, [_I]),
    },
    "trace_level_bwd": {
        "trace_level_bwd_launch": (
            _I, _TABLE_ARGTYPES + [_P] * 28 + [ctypes.c_longlong, _I, _P]
        ),
        "trace_level_bwd_error_string": (ctypes.c_char_p, [_I]),
    },
}
