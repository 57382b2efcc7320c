"""The closest-hit kernels: the folds and the hit record of ``closest_hit_soa``.

Three CUDA kernels serve the closest-hit API (``ops/trace.py``:
``closest_hit_soa``, ``render_depth``, ``trace_soa`` with a fold or a
closest-hit function):

- ``fold_flat`` launches csrc/fold_flat.cu: the brute-force fold, (min t,
  argmin global index) of every ray over every sphere, wall and box, with
  no gate; ``fold="pallas_flat"``.
- ``fold_shortlist`` launches csrc/fold_shortlist.cu: the fold of each
  16x16 tile of an ``[H, W]`` frame over its chunk shortlist, each listed
  chunk behind the lane's own gate; returns (t, index); ``fold="pallas"``.
- ``fold_shortlist_hit`` launches the same source with its record: the fold,
  then the winner's attributes regathered by index and its record math; it
  returns the 16 planes of the hit record (t recomputed, index, point,
  normal, colour, ambient, metallic, diffuse, specular, exponent).

Both run trace_level.cu's fold (csrc trace_common.cuh's ``tile_fold``): the
spheres in shared memory as float4 (``hit_smem_bytes``), a square root
only for a sphere the ray meets ahead, and a warp that folds a chunk for
its lanes together where fewer than ``cuda_level.PAIR_MIN_LANES`` of them pass
its gate. ``fold_shortlist_pair_reference`` and
``fold_shortlist_hit_pair_reference`` mirror that fold in plain PyTorch
(``cuda_level.pair_fold``) and count its work by route; they equal the
plain versions bit for bit.

Each kernel has its plain PyTorch version (``*_reference``), built from
the per-level chain's plain fold (``cuda_fold._fold``) and its record math
(``_gather``, ``_kinds``, ``_record_math``); the wrapper runs it for CPU
tensors and launches the kernel for CUDA tensors, or raises. Each wrapper
counts its launches (``profiler.count_launch``). A lane whose alive plane ``w`` is 0
is dead: both versions give it a miss record, ``(MISS_T, -1)``, the point
``o + d``, the normal (0, 0, 1) and zero materials.

The scene-level entry points (``fold_closest_flat``,
``fold_closest_shortlist``, ``hit_closest_shortlist``) take a scene and rays
of any shape, pack the tables (``cuda_fold.fused_tables``) and, for the
shortlist folds, build the shortlists as the per-level chain does: one
``cuda_level.ray_stats`` launch on the rays with ``w = active``, then
``cuda_level.phase_a``; scenes of fewer than ``_PER_TILE_MIN_CHUNKS``
chunks (and sphere-free ones) walk identity lists. The folds break ties on
the global index, so all three give the same (t, index) for unit
directions; a direction that left unit length after a grazing bounce can
meet a sphere outside a chunk's gate, and there only the gated folds skip
it.
"""

from __future__ import annotations

import ctypes

import torch

from raytracer_tpu_torch.core.types import Scene
from raytracer_tpu_torch.core.v3 import V3
from raytracer_tpu_torch.ops import _build, cuda_fold, cuda_level
from raytracer_tpu_torch.ops.cuda_fold import (
    FusedTables,
    _attr_columns,
    _check_planes,
    _check_table,
    _fold,
    _gather,
    _kinds,
    _raise_on,
    _record_math,
    _srecip,
)
from raytracer_tpu_torch.ops.trace import MISS_T
from raytracer_tpu_torch.utils import profiler

__all__ = [
    "N_RECORD",
    "fold_flat_reference",
    "fold_flat",
    "fold_flat_mirror",
    "flat_plan",
    "flat_rays",
    "flat_smem_bytes",
    "fold_shortlist_reference",
    "fold_shortlist",
    "record_planes",
    "fold_shortlist_hit_reference",
    "fold_shortlist_hit",
    "fold_shortlist_pair_reference",
    "fold_shortlist_hit_pair_reference",
    "hit_smem_bytes",
    "shortlists",
    "fold_closest_flat",
    "fold_closest_shortlist",
    "hit_closest_shortlist",
]

N_RECORD = 16  # planes of a hit record: t, index, point, normal, 8 materials
# fold_flat's launch (csrc/fold_flat.cu): threads a block (its BLOCK); rays
# a thread, FLAT_RAYS, or 1 for a batch of fewer than FLAT_SMALL rays
# (``flat_rays``); the spheres go into shared memory in one copy while the
# table takes at most FLAT_WHOLE_MAX bytes there, else in tiles of FLAT_TILE
# spheres (``flat_plan``).
FLAT_BLOCK = 256
FLAT_RAYS = 2
FLAT_SMALL = 100_000
FLAT_GROUP = 4  # spheres whose tests one guard branch covers (GROUP)
FLAT_WHOLE_MAX = 48 * 1024
FLAT_TILE = 2048
_MIRROR_SLICE = 32  # spheres the plain mirror tests at once (any count gives its result)


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def fold_flat_reference(tables: FusedTables, o: V3, d: V3):
    """Plain version of ``fold_flat``: ``(t, index)`` of every ray over
    every primitive, with no slab clip and no chunk gate (``_fold`` with
    ``gated=False``, one sphere chunk at a time)."""
    return _fold(tables.cols, tables.counts, o, d, gated=False)


def fold_flat_mirror(tables: FusedTables, o: V3, d: V3, rays: int | None = None,
                     block: int | None = None, tile: int | None = None):
    """Plain mirror of ``fold_flat``'s kernel (csrc/fold_flat.cu), in its
    order of work: the flat batch in groups of ``block`` threads of
    ``rays`` rays each (``flat_rays``' by default; ray ``j`` of thread
    ``k`` of group ``g`` is ray ``g * block * rays + j * block + k``; the
    last group's missing rays are tested as a ray from the origin along +z
    and not kept); in a group
    whose rays all start at its first ray's origin (bit for bit), each
    sphere's ``c_full`` taken once from that origin; the spheres in tiles of
    ``tile`` (``flat_plan``'s by default) in ascending index with a strict
    ``<``, the discriminants of ``FLAT_GROUP`` spheres first and the square
    root only where ``disc >= 0`` and ``b_half < 0`` (``sphere_ahead``);
    then the walls and boxes with a strict ``<``, the reciprocal directions
    only where the scene has boxes. Returns ``((t, index), work)``: the pair
    equals ``fold_flat_reference``'s bit for bit, and ``work`` counts the
    kernel's work: its groups (and those of one origin), threads and sphere
    tiles, its ray-sphere tests and those that reach the square root, and
    its warps' guard branches (one for ``FLAT_GROUP`` spheres and a thread's
    rays, one a test past the last whole ``FLAT_GROUP`` of a tile) and those
    taken, where some lane's test meets its sphere ahead."""
    n = d.x.numel()
    rays = flat_rays(n) if rays is None else rays
    block = FLAT_BLOCK if block is None else block
    c, cols = tables.counts, tables.cols
    n_s = c["n_s"]
    tile = flat_plan(tables)[0] if tile is None else tile
    shape, dev = d.x.shape, d.x.device
    group = block * rays
    n_groups = -(-n // group)
    pad = n_groups * group - n

    def lay(x, fill):
        flat = x.reshape(-1)
        return torch.cat([flat, flat.new_full((pad,), fill)]).view(n_groups, rays, block)

    lo = V3(*(lay(x, 0.0) for x in o))
    ld = V3(lay(d.x, 0.0), lay(d.y, 0.0), lay(d.z, 1.0))
    valid = lay(torch.ones(n, dtype=torch.bool, device=dev), False)
    bits = [x.view(torch.int32) for x in lo]
    one = torch.ones(n_groups, dtype=torch.bool, device=dev)
    for b in bits:
        one &= ((b == b[:, :1, :1]) | ~valid).flatten(1).all(dim=1)
    one &= n_s > 0
    o1 = V3(*(x[:, :1, :1] for x in lo))  # each group's first ray's origin
    bt = torch.full(lo.x.shape, MISS_T, dtype=torch.float32, device=dev)
    bi = torch.full(lo.x.shape, -1, dtype=torch.int32, device=dev)
    work = dict(groups=n_groups, one_origin_groups=int(one.sum()), threads=n_groups * block,
                tiles=-(-n_s // tile) if n_s else 0, tests=n_groups * group * n_s, roots=0,
                branches=0, branches_taken=0)
    oo = lo.x * lo.x + lo.y * lo.y + lo.z * lo.z
    do = ld.x * lo.x + ld.y * lo.y + ld.z * lo.z
    oo1 = o1.x * o1.x + o1.y * o1.y + o1.z * o1.z
    one = one.view(-1, 1, 1)
    for base in range(0, n_s, tile):
        end = min(base + tile, n_s)
        whole = base + (end - base) // FLAT_GROUP * FLAT_GROUP
        for s0 in range(base, end, _MIRROR_SLICE):
            sl = slice(s0, min(s0 + _MIRROR_SLICE, end))
            cx, cy, cz, cr2 = (cols[k][sl].view(-1, 1, 1, 1) for k in ("cx", "cy", "cz", "cr2"))
            s = ld.x * cx + ld.y * cy + ld.z * cz
            b_half = do - s
            m = lo.x * cx + lo.y * cy + lo.z * cz
            m1 = o1.x * cx + o1.y * cy + o1.z * cz
            c_full = torch.where(one, oo1 - 2.0 * m1 + cr2, oo - 2.0 * m + cr2)
            disc = b_half * b_half - c_full
            ahead = (disc >= 0.0) & (b_half < 0.0)
            tt = -b_half - torch.sqrt(torch.where(ahead, disc, 0.0))
            ok = ahead & (tt > 0.0) & (tt < MISS_T)
            ct, ci = cuda_fold._lexmin(torch.where(ok, tt, MISS_T), sl.start)
            win = (ci >= 0) & (ct < bt)
            bt, bi = torch.where(win, ct, bt), torch.where(win, ci, bi)
            work["roots"] += int(ahead.sum())
            warps = ahead.view(*ahead.shape[:-1], block // 32, 32).any(dim=-1)
            k = max(0, min(whole, sl.stop) - sl.start)  # spheres of whole groups
            grouped = warps[:k].view(k // FLAT_GROUP, FLAT_GROUP, *warps.shape[1:]).any(dim=1)
            grouped = grouped.any(dim=2)  # and over the thread's rays
            work["branches"] += grouped.numel() + warps[k:].numel()
            work["branches_taken"] += int(grouped.sum()) + int(warps[k:].sum())
    iv = (_srecip(ld.x), _srecip(ld.y), _srecip(ld.z)) if c["n_b"] else None
    cands = cuda_fold._wall_box_candidates(cols, c, lo, ld, iv)
    if cands:
        ct, ci = cuda_fold._lexmin(torch.cat(cands), n_s)
        win = (ci >= 0) & (ct < bt)
        bt, bi = torch.where(win, ct, bt), torch.where(win, ci, bi)
    return (bt.reshape(-1)[:n].view(shape), bi.reshape(-1)[:n].view(shape)), work


def _as_lists(shortlist, shape, tile, device):
    """Each lane's tile's ``(chunk order, list length)`` for ``_fold``."""
    if shortlist is None:
        return None
    chunk_list, counts = shortlist
    tid = cuda_level._tile_index(shape, tile, device)
    return chunk_list.long()[tid], counts[tid]


def fold_shortlist_reference(tables: FusedTables, shortlist, o: V3, d: V3, w: torch.Tensor,
                             tile=None):
    """Plain version of ``fold_shortlist``: ``(t, index)`` of every lane of
    the ``[H, W]`` planes; each lane with ``w > 0`` folds the walls and
    boxes, then its tile's listed chunks behind its gate (``shortlist`` is
    ``phase_a``'s ``(chunk_list, counts)``, or ``None`` for identity
    lists); a dead lane gets ``(MISS_T, -1)``."""
    bt, bi = _fold(tables.cols, tables.counts, o, d,
                   _as_lists(shortlist, w.shape, tile, w.device))
    alive = w > 0.0
    return torch.where(alive, bt, MISS_T), torch.where(alive, bi, -1)


def record_planes(cols, counts: dict, o: V3, d: V3, bt: torch.Tensor, bi: torch.Tensor):
    """The 16 planes of the hit record at the selection ``(bt, bi)``: the
    winner's t (``_record_math``'s, the fold's where the recompute does not
    apply), its index, hit point xyz, normal xyz and the 8 material planes.
    ``cols`` are the 14 per-primitive attribute columns (``_attr_columns``
    order, or ``attribute_tables``' columns, whose autograd reaches the
    scene's leaves). A miss gets ``(MISS_T, -1)``, the point ``o + d``, the
    normal (0, 0, 1) and zero materials."""
    hit = bt < MISS_T
    acc = _gather(cols, bi, hit)
    tt, hp, hn = _record_math(acc, bt, hit, *_kinds(bi, hit, counts), o, d)
    return (tt, bi, *hp, *hn, *acc[6:])


def fold_shortlist_hit_reference(tables: FusedTables, shortlist, o: V3, d: V3,
                                 w: torch.Tensor, tile=None):
    """Plain version of ``fold_shortlist_hit``: ``fold_shortlist_reference``,
    then ``record_planes`` from the fused table's attribute columns."""
    bt, bi = fold_shortlist_reference(tables, shortlist, o, d, w, tile)
    return record_planes(_attr_columns(tables.cols, tables.counts), tables.counts, o, d, bt, bi)


def fold_shortlist_pair_reference(tables: FusedTables, shortlist, o: V3, d: V3,
                                  w: torch.Tensor, k_min: int = cuda_level.PAIR_MIN_LANES, tile=None):
    """Plain mirror of ``fold_shortlist``'s kernel: its warp-cooperative
    fold (``cuda_level.pair_fold`` at threshold ``k_min``), dead lanes
    given ``(MISS_T, -1)``. Returns ``((t, index), work)``: the pair equals
    ``fold_shortlist_reference``'s bit for bit, and ``work`` is the fold's
    work by route."""
    bt, bi, work = cuda_level.pair_fold(tables, shortlist, o, d, w, k_min, tile)
    alive = w > 0.0
    return (torch.where(alive, bt, MISS_T), torch.where(alive, bi, -1)), work


def fold_shortlist_hit_pair_reference(tables: FusedTables, shortlist, o: V3, d: V3,
                                      w: torch.Tensor, k_min: int = cuda_level.PAIR_MIN_LANES,
                                      tile=None):
    """Plain mirror of ``fold_shortlist_hit``'s kernel:
    ``fold_shortlist_pair_reference``, then ``record_planes``. Returns
    ``(planes, work)``; the 16 planes equal
    ``fold_shortlist_hit_reference``'s bit for bit."""
    (bt, bi), work = fold_shortlist_pair_reference(tables, shortlist, o, d, w, k_min, tile)
    cols = _attr_columns(tables.cols, tables.counts)
    return record_planes(cols, tables.counts, o, d, bt, bi), work


def flat_plan(tables: FusedTables) -> tuple[int, int]:
    """``(tile, shared bytes)`` of a ``fold_flat`` launch: the spheres as
    float4 (centre, |c|^2 - r^2), the whole table in one copy while that
    and the walls and boxes take at most ``FLAT_WHOLE_MAX`` bytes, else
    ``FLAT_TILE`` spheres at a time; then the walls' (15 floats each) and
    the boxes' (6) columns as they are in the packed table. The layout of
    csrc/fold_flat.cu (``fold_flat_smem_bytes``)."""
    n_s = tables.counts["n_s"]
    tile = max(n_s, 1) if _flat_bytes(tables, n_s) <= FLAT_WHOLE_MAX else FLAT_TILE
    return tile, _flat_bytes(tables, tile)


def _flat_bytes(tables: FusedTables, tile: int) -> int:
    c = tables.counts
    return 16 * min(tile, c["n_s"]) + 4 * (15 * c["n_w"] + 6 * c["n_b"])


def flat_rays(n: int) -> int:
    """Rays a thread of a ``fold_flat`` launch of ``n`` rays: ``FLAT_RAYS``,
    or 1 below ``FLAT_SMALL`` rays (each level of a 320x240 frame), where
    two a thread would leave too few blocks to fill the card."""
    return FLAT_RAYS if n >= FLAT_SMALL else 1


def flat_smem_bytes(tables: FusedTables) -> int:
    """Dynamic shared bytes of a ``fold_flat`` launch (``flat_plan``)."""
    return flat_plan(tables)[1]


def hit_smem_bytes(tables: FusedTables) -> int:
    """Dynamic shared bytes of a ``fold_shortlist(_hit)`` launch
    (csrc/fold_shortlist.cu): the spheres as float4 (centre, |c|^2 - r^2),
    the walls, boxes, chunk tables, slab, lights and sky as they are in the
    packed table, and one tile's shortlist (``n_c`` int32): trace_level's
    layout without its stats scratch."""
    return cuda_level.level_smem_bytes(tables, False)


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def fold_flat(tables: FusedTables, o: V3, d: V3):
    """``(t f32, index i32)`` of every ray over every primitive, the
    brute-force fold. Inputs: six contiguous float32 planes of one shape (any
    shape: the kernel walks them as a flat batch) on one device. On CPU
    tensors this is ``fold_flat_reference``; on CUDA tensors it launches
    csrc/fold_flat.cu on the current stream (``flat_plan``, ``flat_rays``),
    or raises."""
    dev, shape = d.x.device, d.x.shape
    _check_planes((*o, *d), shape, dev, "fold_flat")
    if dev.type == "cpu":
        return fold_flat_reference(tables, o, d)
    _check_table(tables, 0, dev, "fold_flat")
    tile, smem = flat_plan(tables)
    if smem > cuda_fold._SMEM_MAX:
        raise ValueError(f"fold_flat: the walls and boxes and a tile of {tile} spheres take "
                         f"{smem} bytes of shared memory; a block has {cuda_fold._SMEM_MAX}")
    t = torch.empty(shape, dtype=torch.float32, device=dev)
    i = torch.empty(shape, dtype=torch.int32, device=dev)
    if t.numel():
        lib = _build.load("fold_flat", _SIGNATURES["fold_flat"])
        err = lib.fold_flat_launch(
            *cuda_level._table_args(tables), tile, flat_rays(t.numel()),
            *cuda_level._ptrs((*o, *d, t, i)), t.numel(), _stream(dev),
        )
        _raise_on(err, lib, "fold_flat")
        profiler.count_launch("fold_flat")
    return t, i


def _check_shortlist_call(tables, shortlist, o, d, w, tile, name):
    dev, shape = w.device, w.shape
    _check_planes((*o, *d, w), shape, dev, name)
    cuda_level._check_grid(shape, name)
    if shortlist is not None:
        (_, th, tw), n_c = cuda_level.tile_grid(shape, tile), tables.counts["n_c"]
        _check_planes((shortlist[0],), (th * tw, n_c), dev, name, torch.int32)
        _check_planes((shortlist[1],), (th * tw,), dev, name, torch.int32)
    if dev.type != "cpu":
        _check_table(tables, 0, dev, name)


def _fold_shortlist_cuda(tables, shortlist, o, d, w, tile, record: bool):
    shape, dev = w.shape, w.device
    (tr, tc), _, _ = cuda_level.tile_grid(shape, tile)
    t = torch.empty(shape, dtype=torch.float32, device=dev)
    i = torch.empty(shape, dtype=torch.int32, device=dev)
    rec = (torch.empty((N_RECORD - 2, *shape), dtype=torch.float32, device=dev).unbind(0)
           if record else (None,) * (N_RECORD - 2))
    if w.numel():
        lib = _build.load("fold_shortlist", _SIGNATURES["fold_shortlist"])
        err = lib.fold_shortlist_launch(
            *cuda_level._table_args(tables),
            *cuda_level._ptrs(shortlist if shortlist is not None else (None, None)),
            *cuda_level._ptrs((*o, *d, w, t, i, *rec)), shape[0], shape[1], tr, tc,
            _stream(dev),
        )
        _raise_on(err, lib, "fold_shortlist")
        profiler.count_launch("fold_shortlist_hit" if record else "fold_shortlist")
    return (t, i, *rec) if record else (t, i)


def fold_shortlist(tables: FusedTables, shortlist, o: V3, d: V3, w: torch.Tensor, tile=None):
    """``(t f32, index i32)`` of every lane of the ``[H, W]`` planes over
    its tile's shortlist (``phase_a``'s ``(chunk_list, counts)`` for
    ``tile``, or ``None`` for identity lists); lanes with ``w == 0`` are
    dead and get ``(MISS_T, -1)``. On CPU tensors this is
    ``fold_shortlist_reference``; on CUDA tensors it launches
    csrc/fold_shortlist.cu on the current stream, or raises."""
    _check_shortlist_call(tables, shortlist, o, d, w, tile, "fold_shortlist")
    if w.device.type == "cpu":
        return fold_shortlist_reference(tables, shortlist, o, d, w, tile)
    return _fold_shortlist_cuda(tables, shortlist, o, d, w, tile, record=False)


def fold_shortlist_hit(tables: FusedTables, shortlist, o: V3, d: V3, w: torch.Tensor,
                       tile=None):
    """The hit record of every lane of the ``[H, W]`` planes: the 16 planes
    of ``record_planes`` at ``fold_shortlist``'s selection. On CPU tensors
    this is ``fold_shortlist_hit_reference``; on CUDA tensors it launches
    csrc/fold_shortlist.cu with its record on the current stream, or
    raises."""
    _check_shortlist_call(tables, shortlist, o, d, w, tile, "fold_shortlist_hit")
    if w.device.type == "cpu":
        return fold_shortlist_hit_reference(tables, shortlist, o, d, w, tile)
    return _fold_shortlist_cuda(tables, shortlist, o, d, w, tile, record=True)


# ---------------------------------------------------------------------------
# Scene-level entry points
# ---------------------------------------------------------------------------


def _frame(o: V3, d: V3, active):
    """The rays and the alive plane as contiguous ``[H, W]`` planes (a 1-D
    batch becomes one row, leading axes fold into the rows), and the
    broadcast shape to give the results back in."""
    shape = torch.broadcast_shapes(*(c.shape for c in (*o, *d)))
    if active is not None:
        shape = torch.broadcast_shapes(shape, active.shape)
    n = 1
    for s in shape:
        n *= s
    w_ = shape[-1] if len(shape) >= 1 and shape[-1] else 1
    hw = (n // w_, w_) if n else (0, w_)

    def plane(c):
        return torch.broadcast_to(c, shape).reshape(hw).contiguous()

    dev = d.x.device
    w = (torch.ones(hw, dtype=torch.float32, device=dev) if active is None
         else plane(active.to(torch.float32)))
    return V3(*(plane(c) for c in o)), V3(*(plane(c) for c in d)), w, shape


def shortlists(tables: FusedTables, o: V3, d: V3, w: torch.Tensor, tile=None):
    """The per-tile chunk shortlists of these ``[H, W]`` rays for
    ``fold_shortlist(_hit)``: ``phase_a`` of one ``ray_stats`` launch on the
    rays alive under ``w``, or ``None`` (identity lists) for scenes below
    ``_PER_TILE_MIN_CHUNKS`` chunks."""
    if not cuda_level.uses_shortlists(tables) or not w.numel():
        return None
    return cuda_level.phase_a(cuda_level.ray_stats(tables, o, d, w, tile), tables)


def fold_closest_flat(scene: Scene, o: V3, d: V3):
    """``(t, index)`` of every ray over every primitive of ``scene``
    (``fold_flat``), in the rays' broadcast shape. The fold of
    ``fold="pallas_flat"``."""
    o, d, _, shape = _frame(o, d, None)
    t, i = fold_flat(cuda_fold.fused_tables(scene), o, d)
    return t.reshape(shape), i.reshape(shape)


def fold_closest_shortlist(scene: Scene, o: V3, d: V3, *, active=None):
    """``(t, index)`` of every ray through the shortlist fold
    (``fold_shortlist``), in the rays' broadcast shape. ``active``
    (optional bool, broadcastable to the rays): lanes whose result is
    unused; they leave the shortlists' stats and get ``(MISS_T, -1)``. The
    fold of ``fold="pallas"`` and ``"auto"``; tagged ``_emits_hit_record``,
    since ``hit_closest_shortlist`` gives its full record in one launch."""
    o, d, w, shape = _frame(o, d, active)
    tables = cuda_fold.fused_tables(scene)
    t, i = fold_shortlist(tables, shortlists(tables, o, d, w), o, d, w)
    return t.reshape(shape), i.reshape(shape)


fold_closest_shortlist._emits_hit_record = True


def hit_closest_shortlist(scene: Scene, o: V3, d: V3, *, active=None):
    """The 16 planes of every ray's hit record (``fold_shortlist_hit``), in
    the rays' broadcast shape; ``active`` as ``fold_closest_shortlist``
    takes it. Selection only: ``ops/trace.py:_ShortlistHit`` gives it a
    backward."""
    o, d, w, shape = _frame(o, d, active)
    tables = cuda_fold.fused_tables(scene)
    out = fold_shortlist_hit(tables, shortlists(tables, o, d, w), o, d, w)
    return tuple(p.reshape(shape) for p in out)


# C signatures of the exported functions of csrc/fold_flat.cu and
# csrc/fold_shortlist.cu.
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "fold_flat": {
        "fold_flat_launch": (
            _I, cuda_level._TABLE_ARGTYPES + [_I] * 2 + [_P] * 8 + [ctypes.c_longlong, _P]
        ),
        "fold_flat_smem_bytes": (ctypes.c_longlong, [_I] * 4),
        "fold_flat_error_string": (ctypes.c_char_p, [_I]),
    },
    "fold_shortlist": {
        "fold_shortlist_launch": (
            _I, cuda_level._TABLE_ARGTYPES + [_P] * 25 + [_I] * 4 + [_P]
        ),
        "fold_shortlist_error_string": (ctypes.c_char_p, [_I]),
    },
}
