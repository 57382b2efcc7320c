"""The whole-trace kernel: every bounce level of a ray tile in one launch.

``trace_whole`` launches csrc/trace_whole.cu, a CUDA kernel with one thread
per ray, its warps 4 x 8 pixels of a tile where the frame and the scene call
for it (``whole_grid``). For each level the thread folds the closest hit over
walls, boxes and sphere chunks (ties broken on the global index; a warp
folds a chunk that few of its lanes reach together), regathers the
winner's attributes, shades it with Blinn-Phong point and sun lights (or the
sky on a miss), accumulates, and reflects (``_bounce``: the upstream's
reflect, with the direction and the normal made unit).
``trace_whole_reference`` is its plain PyTorch version: the same
arithmetic, op for op, vectorised over primitives; ``whole_pair_reference``
mirrors the kernel's fold route by route in its lane layout, with the same
outputs.

The scene reaches the kernel as one packed float32 table (``FusedTables``),
copied into shared memory by each block (for most scenes the spheres as
float4 and the materials left in device memory: ``whole_smem_bytes``). Its
layout, column
by column (each column holds one value per item of its group), is
``_LAYOUT`` below and is mirrored by ``make_layout`` in the CUDA source.

A lane whose throughput is 0 at a level is dead there: the kernel skips it,
and both versions write ``(MISS_T, -1)`` as its (t, index) and leave its
ray, throughput and accumulator unchanged.

The backward: ``trace_whole(..., emit_res=True)`` also writes each level's
input rays and throughput, and ``trace_whole_bwd`` launches
csrc/trace_whole_bwd.cu, which sweeps the levels in reverse from those
residuals and runs the hand-derived adjoint of ``_level_math`` (the
differentiable part of a level, at fixed selections). Its plain version,
``trace_whole_bwd_reference``, replays ``_level_math`` under autograd. Both
return cotangents of the rays and of ``attribute_tables(scene)``, whose
autograd carries them back to the scene's leaves.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from raytracer_tpu_torch.core.types import Scene
from raytracer_tpu_torch.core.v3 import V3
from raytracer_tpu_torch.ops import _build
from raytracer_tpu_torch.ops.trace import MISS_T, REFLECT_EPS, _wall_tables
from raytracer_tpu_torch.utils import profiler

__all__ = [
    "FUSED_MAX_CHUNKS",
    "FUSED_MAX_DEPTH",
    "FusedTables",
    "max_c",
    "resolve_unroll",
    "resolve_gate_geom",
    "fused_tables",
    "in_fused_class",
    "check_fused_class",
    "attribute_tables",
    "Residuals",
    "trace_whole_reference",
    "WHOLE_TILE",
    "whole_grid",
    "whole_pair_reference",
    "trace_whole",
    "whole_smem_bytes",
    "whole_bwd_smem_bytes",
    "trace_level_bwd_reference",
    "trace_whole_bwd_reference",
    "trace_whole_bwd",
]

# The fused class: scenes of at most 24 sphere chunks traced to at most 10
# bounces (the reference renderer's own maximum recursion depth), whose
# packed table fits the shared memory a block gets by default. The JAX
# package stops at 4 chunks. With both routes redesigned, the whole-trace
# kernels beat the per-level chain's at every chunk count of the class,
# forward and backward (grids of 64 to 768 spheres, 4 to 24 chunks, at
# 1920x1080 d3; grid-768 1.52 against 2.13 ms of kernels forward, 0.65
# against 0.72 backward, on an NVIDIA H100 80GB HBM3 at 700 W;
# chip_smoke.py's `whole_vs_levels`, PERF.md). Whether the class should
# take larger tables (grid-1024's no longer fits) is open (ROADMAP).
FUSED_MAX_CHUNKS = 24
FUSED_MAX_DEPTH = 10
_SMEM_LIMIT = 48 * 1024  # dynamic shared memory a block gets by default

# Pixels of a block's tile in the whole-trace forward, (rows, cols), where
# the frame and the scene call for it (``whole_grid``): warps of 4 x 8
# pixels. Picked by measurement on the H100 (PERF.md).
WHOLE_TILE = (32, 8)
_WHOLE_BLOCK = 256  # threads of a block of both whole-trace kernels (csrc BLOCK)
_SMEM_MAX = 232448  # dynamic shared memory a block can have on the H100
# Mirrors of csrc: the light and sky slots each lane of the backward keeps
# (trace_common.cuh's LANE_LS_MAX), and the sphere count up to which it sums
# sphere rows in shared memory (trace_whole_bwd.cu's SHARED_SPHERES_MAX).
_LANE_LS_MAX = 32
_SHARED_SPHERES_MAX = 16

_AABB_PAD = 1e-3  # chunk-box inflation absorbing float32 rounding
_GATE_PAD = 1e-2  # bounding-sphere inflation for the tube gate

GATE_AABB, GATE_SPHERE = 0, 1

# (count key, column names) per group, in table order.
_LAYOUT = (
    ("n_s", ("cx", "cy", "cz", "cr2", "srad")),
    ("n_w", ("nx", "ny", "nz", "dpl", "rx", "ry", "rz", "ux", "uy", "uz",
             "px", "py", "pz", "ln", "wd")),
    ("n_b", ("bmnx", "bmny", "bmnz", "bmxx", "bmxy", "bmxz")),
    ("n_prim", ("mcr", "mcg", "mcb", "mam", "mmt", "mdf", "msp", "mex")),
    ("n_c", ("alx", "aly", "alz", "ahx", "ahy", "ahz",
             "gx", "gy", "gz", "gg", "gr2")),
    ("one", ("slab_lo_x", "slab_lo_y", "slab_lo_z",
             "slab_hi_x", "slab_hi_y", "slab_hi_z")),
    ("n_pt", ("lpx", "lpy", "lpz", "lcr", "lcg", "lcb")),
    ("n_sun", ("sdx", "sdy", "sdz", "scr", "scg", "scb")),
    ("sky", ("sky",)),  # horizon rgb, zenith rgb, ground rgb, exponent
)

# Winner geometry g0..g5 by primitive kind (sphere, wall, box; None is a
# zero column), then the material columns: the 14 attribute columns.
_GEOM_COLS = (
    ("cx", "nx", "bmnx"), ("cy", "ny", "bmny"), ("cz", "nz", "bmnz"),
    ("srad", "px", "bmxx"), (None, "py", "bmxy"), (None, "pz", "bmxz"),
)
_MAT_COLS = ("mcr", "mcg", "mcb", "mam", "mmt", "mdf", "msp", "mex")


def resolve_unroll(n_s: int) -> int:
    """Spheres per chunk: a scene of at most 16 spheres is one chunk of
    exactly its spheres; larger scenes use chunks of 16 (32 from 256 on)."""
    if 0 < n_s <= 16:
        return n_s
    return 32 if n_s >= 256 else 16


def resolve_gate_geom(n_s: int, unroll: int) -> int:
    """Chunk-gate geometry: chunk boxes for multi-chunk scenes, the chunk's
    bounding sphere for a single chunk (a lone sphere's bounding sphere is
    the sphere itself, where its box is the looser shape)."""
    n_chunks = -(-n_s // unroll) if n_s else 0
    return GATE_AABB if n_chunks >= 2 else GATE_SPHERE


@dataclasses.dataclass(frozen=True)
class FusedTables:
    """A scene packed for the whole-trace kernel.

    ``cols`` maps each ``_LAYOUT`` column name to its 1-D tensor; ``packed``
    is their concatenation in layout order, which the kernel reads.
    """

    cols: dict
    packed: torch.Tensor
    counts: dict  # n_s, unroll, n_c, n_w, n_b, n_pt, n_sun, gate

    @property
    def smem_bytes(self) -> int:
        return self.packed.numel() * 4


def _packed_fold_tables(scene: Scene) -> dict:
    """Fold columns: sphere centers, |c|^2 - r^2 and radii; the wall
    tables; box corners. Unpadded: the kernel's loop bounds are exact."""
    s = scene.spheres
    c = s.center
    cr2 = c[:, 0] ** 2 + c[:, 1] ** 2 + c[:, 2] ** 2 - s.radius * s.radius
    w = _wall_tables(scene.walls)
    b = scene.boxes
    return {
        "cx": c[:, 0], "cy": c[:, 1], "cz": c[:, 2], "cr2": cr2,
        "srad": s.radius,
        "nx": w["nx"], "ny": w["ny"], "nz": w["nz"], "dpl": w["dplane"],
        "rx": w["rx"], "ry": w["ry"], "rz": w["rz"],
        "ux": w["ux"], "uy": w["uy"], "uz": w["uz"],
        "px": w["px"], "py": w["py"], "pz": w["pz"],
        "ln": w["length"], "wd": w["width"],
        "bmnx": b.minimum[:, 0], "bmny": b.minimum[:, 1], "bmnz": b.minimum[:, 2],
        "bmxx": b.maximum[:, 0], "bmxy": b.maximum[:, 1], "bmxz": b.maximum[:, 2],
    }


def _packed_mat_tables(scene: Scene) -> dict:
    """Material columns with one row per primitive at its global index:
    spheres, then walls, then boxes."""
    mats = [scene.spheres.material, scene.walls.material, scene.boxes.material]

    def col(get):
        return torch.cat([get(m) for m in mats])

    return {
        "mcr": col(lambda m: m.color[:, 0]), "mcg": col(lambda m: m.color[:, 1]),
        "mcb": col(lambda m: m.color[:, 2]), "mam": col(lambda m: m.ambient),
        "mmt": col(lambda m: m.metallic), "mdf": col(lambda m: m.diffuse),
        "msp": col(lambda m: m.specular),
        "mex": col(lambda m: m.specular_exponent),
    }


def _light_cols(lights) -> dict:
    """Point lights and sun lights (directions made unit here), one column
    per component."""
    lp, lc, sc = lights.point_position, lights.point_color, lights.sun_color
    sd = lights.sun_direction
    if sd.shape[0]:
        sd = sd * torch.rsqrt(torch.sum(sd * sd, dim=-1, keepdim=True))
    out = {}
    for names, a in (
        (("lpx", "lpy", "lpz"), lp), (("lcr", "lcg", "lcb"), lc),
        (("sdx", "sdy", "sdz"), sd), (("scr", "scg", "scb"), sc),
    ):
        out.update({n: a[:, k] for k, n in enumerate(names)})
    return out


def _sky_vector(sky) -> torch.Tensor:
    """The ten sky scalars: horizon rgb, zenith rgb, ground rgb, exponent."""
    return torch.cat([
        sky.horizon_color, sky.zenith_color, sky.ground_color,
        sky.gradient_exponent.reshape(1),
    ])


def _light_sky_tables(scene: Scene) -> dict:
    """Point lights, sun lights (directions made unit here) and the ten sky
    scalars."""
    return {**_light_cols(scene.lights), "sky": _sky_vector(scene.sky)}


def _chunk_culling_tables(scene: Scene, unroll: int) -> dict:
    """Per-chunk gate tables and the sphere-set slab.

    Chunk ``c`` holds spheres ``[c * unroll, (c + 1) * unroll)``. Each
    chunk gets its box (inflated by ``_AABB_PAD``) and a bounding sphere:
    the box midpoint as center, the largest member reach plus ``_GATE_PAD``
    as radius. The slab is the box of all spheres. The gates only skip a
    chunk that no hit on the ray's live segment can come from, so the fold
    is the same with or without them. All chunks at once, a fixed number of
    ops whatever the scene's size.
    """
    s = scene.spheres
    n_s = len(s)
    n_c = -(-n_s // unroll) if n_s else 0
    pad = n_c * unroll - n_s
    lo_all, hi_all = s.center - s.radius[:, None], s.center + s.radius[:, None]

    def chunked(x, fill):
        x = torch.cat([x, x.new_full((pad, *x.shape[1:]), fill)]) if pad else x
        return x.reshape(n_c, unroll, *x.shape[1:])

    lo = chunked(lo_all, float("inf")).amin(dim=1) - _AABB_PAD  # [n_c, 3]
    hi = chunked(hi_all, float("-inf")).amax(dim=1) + _AABB_PAD
    g = 0.5 * (lo + hi)
    rel = chunked(s.center, 0.0) - g[:, None]
    reach = torch.sqrt(rel[..., 0] ** 2 + rel[..., 1] ** 2 + rel[..., 2] ** 2)
    reach = chunked(s.radius, float("-inf")) + reach
    gr = reach.amax(dim=1)
    out = {
        "alx": lo[:, 0], "aly": lo[:, 1], "alz": lo[:, 2],
        "ahx": hi[:, 0], "ahy": hi[:, 1], "ahz": hi[:, 2],
        "gx": g[:, 0], "gy": g[:, 1], "gz": g[:, 2],
        "gg": g[:, 0] * g[:, 0] + g[:, 1] * g[:, 1] + g[:, 2] * g[:, 2],
        "gr2": (gr + _GATE_PAD) ** 2,
        # Not packed: phase A's copies (cuda_level.phase_a), the chunk
        # boxes and centers [3, n_c] and the unpadded bounding radius.
        "c_lo": lo.t().contiguous(), "c_hi": hi.t().contiguous(),
        "c_g": g.t().contiguous(), "gr": gr,
    }
    if n_s:
        lo, hi = lo_all.amin(dim=0) - _AABB_PAD, hi_all.amax(dim=0) + _AABB_PAD
    else:
        lo = hi = lo_all.new_zeros((3,))
    for k, ax in enumerate("xyz"):
        out["slab_lo_" + ax] = lo[k:k + 1]
        out["slab_hi_" + ax] = hi[k:k + 1]
    return out


def fused_tables(scene: Scene) -> FusedTables:
    """Pack ``scene`` for the kernel (on the scene's device)."""
    with torch.no_grad():
        n_s = len(scene.spheres)
        unroll = resolve_unroll(n_s)
        cols = {
            **_packed_fold_tables(scene),
            **_packed_mat_tables(scene),
            **_chunk_culling_tables(scene, unroll),
            **_light_sky_tables(scene),
        }
        counts = {
            "n_s": n_s, "unroll": unroll, "n_c": -(-n_s // unroll) if n_s else 0,
            "n_w": len(scene.walls), "n_b": len(scene.boxes),
            "n_pt": scene.lights.point_position.shape[0],
            "n_sun": scene.lights.sun_color.shape[0],
            "gate": resolve_gate_geom(n_s, unroll),
        }
        sizes = {**counts, "n_prim": scene.num_primitives, "one": 1, "sky": 10}
        order = [name for _, names in _LAYOUT for name in names]
        for key, names in _LAYOUT:
            for name in names:
                if cols[name].shape != (sizes[key],):
                    raise ValueError(
                        f"table column {name} has shape {tuple(cols[name].shape)}, "
                        f"expected ({sizes[key]},)"
                    )
        packed = torch.cat([cols[n].to(torch.float32) for n in order]).contiguous()
    return FusedTables(cols, packed, counts)


def in_fused_class(tables: FusedTables, depth: int) -> bool:
    """Whether the whole-trace kernels take this trace: at most
    ``FUSED_MAX_CHUNKS`` sphere chunks, ``0 <= depth <= FUSED_MAX_DEPTH``,
    and a table that fits the shared memory a block gets by default.
    ``trace_soa`` sends everything else through the per-level chain
    (ops/cuda_level.py)."""
    return (tables.counts["n_c"] <= FUSED_MAX_CHUNKS and 0 <= depth <= FUSED_MAX_DEPTH
            and tables.smem_bytes <= _SMEM_LIMIT)


def check_fused_class(scene: Scene, depth: int) -> None:
    """Raise ``NotImplementedError`` for a trace outside the whole-trace
    kernels' class (``in_fused_class``)."""
    tables = fused_tables(scene)
    if not in_fused_class(tables, depth):
        raise NotImplementedError(
            f"{tables.counts['n_s']} spheres ({tables.counts['n_c']} chunks, a "
            f"{tables.smem_bytes}-byte table) at depth {depth} is outside the "
            f"whole-trace kernel's class (<= {FUSED_MAX_CHUNKS} chunks, 0 <= depth "
            f"<= {FUSED_MAX_DEPTH}, <= {_SMEM_LIMIT} bytes); trace_soa runs such "
            "scenes through the per-level kernels (ops/cuda_level.py)"
        )


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def max_c(x: torch.Tensor, c: float) -> torch.Tensor:
    """``max(x, c)`` for a constant ``c`` with the JAX package's derivative
    (``jnp.maximum(x, c)``): at a tie ``x == c``, ``x`` gets half of the
    cotangent (``torch.maximum``'s rule; ``torch.clamp_min`` would pass all
    of it). The value is the clamp's."""
    return torch.maximum(x, x.new_full((), c))


def _srecip(c: torch.Tensor) -> torch.Tensor:
    """Sign-preserving safe reciprocal: ``1/c``, or +-1e30 where |c| <= 1e-12."""
    ok = torch.abs(c) > 1e-12
    return torch.where(
        ok, 1.0 / torch.where(ok, c, 1.0), torch.where(c >= 0.0, 1e30, -1e30)
    )


def _lexmin(ts: torch.Tensor, base):
    """(min t, lowest index among the minima) over a ``[n, ...]`` stack of
    candidate t (``MISS_T`` where invalid), indices ``base + position``
    (``base`` an int or a per-lane tensor); ``(MISS_T, -1)`` where nothing
    is valid."""
    bt = ts.amin(dim=0)
    n = ts.shape[0]
    pos = torch.arange(n, dtype=torch.int32, device=ts.device).view(-1, *([1] * (ts.dim() - 1)))
    bi = torch.where(ts == bt, pos, n).amin(dim=0) + base
    return bt, torch.where(bt < MISS_T, bi, -1).to(torch.int32)


def _slab_segment(t: dict, o: V3, iv):
    """(t0, t_ex, seg_ok): each ray's live segment inside the slab of all
    spheres, and whether it meets the slab at all."""
    a = [((t[f"slab_lo_{x}"] - oc) * ivc, (t[f"slab_hi_{x}"] - oc) * ivc)
         for x, oc, ivc in zip("xyz", o, iv)]
    t0 = max_c(torch.maximum(torch.maximum(
        torch.minimum(*a[0]), torch.minimum(*a[1])), torch.minimum(*a[2])), 0.0)
    t_ex = torch.minimum(torch.minimum(
        torch.maximum(*a[0]), torch.maximum(*a[1])), torch.maximum(*a[2]))
    return t0, t_ex, (t_ex >= t0) & (t_ex > 0.0)


def _chunk_gate(t: dict, gate: int, c, o: V3, d: V3, iv, oo, do, t0, t1):
    """Whether the segment [t0, t1] can reach chunk ``c`` (an int, or a
    per-lane index tensor): its box (``GATE_AABB``) or its bounding sphere."""
    if gate == GATE_AABB:
        b = [((t[f"al{x}"][c] - oc) * ivc, (t[f"ah{x}"][c] - oc) * ivc)
             for x, oc, ivc in zip("xyz", o, iv)]
        tn = torch.maximum(torch.maximum(
            torch.minimum(*b[0]), torch.minimum(*b[1])), torch.minimum(*b[2]))
        tf = torch.minimum(torch.minimum(
            torch.maximum(*b[0]), torch.maximum(*b[1])), torch.maximum(*b[2]))
        return torch.maximum(tn, t0) <= torch.minimum(tf, t1)
    gx, gy, gz = t["gx"][c], t["gy"][c], t["gz"][c]
    s_g = d.x * gx + d.y * gy + d.z * gz
    m_g = o.x * gx + o.y * gy + o.z * gz
    tc = torch.minimum(torch.maximum(s_g - do, t0), t1)
    dist2 = oo - 2.0 * m_g + t["gg"][c] + tc * (2.0 * (do - s_g) + tc)
    return (t1 >= t0) & (dist2 <= t["gr2"][c])


def _wall_box_candidates(t: dict, counts: dict, o: V3, d: V3, iv) -> list:
    """Each wall's and each box's t for every ray (``MISS_T`` where it is
    not hit): one ``[n_w, ...]`` and one ``[n_b, ...]`` stack, each only
    where the scene has such primitives. ``iv`` (the safe reciprocal
    direction) is read only for boxes."""
    ox, oy, oz = o
    dx, dy, dz = d
    nd = dx.dim()

    def col(name):
        return t[name].view(-1, *([1] * nd))

    cands = []
    if counts["n_w"]:
        nx, ny, nz = col("nx"), col("ny"), col("nz")
        denom = dx * nx + dy * ny + dz * nz
        num = col("dpl") - (ox * nx + oy * ny + oz * nz)
        ok = torch.abs(denom) > 1e-12
        tt = num / torch.where(ok, denom, 1.0)
        relx = ox + dx * tt - col("px")
        rely = oy + dy * tt - col("py")
        relz = oz + dz * tt - col("pz")
        u = relx * col("rx") + rely * col("ry") + relz * col("rz")
        v = relx * col("ux") + rely * col("uy") + relz * col("uz")
        valid = (
            ok & (tt > 0.0) & (tt < MISS_T)
            & (u >= 0.0) & (u <= col("ln")) & (v >= 0.0) & (v <= col("wd"))
        )
        cands.append(torch.where(valid, tt, MISS_T))
    if counts["n_b"]:
        ivx, ivy, ivz = iv
        t1x, t2x = (col("bmnx") - ox) * ivx, (col("bmxx") - ox) * ivx
        t1y, t2y = (col("bmny") - oy) * ivy, (col("bmxy") - oy) * ivy
        t1z, t2z = (col("bmnz") - oz) * ivz, (col("bmxz") - oz) * ivz
        tn = torch.maximum(
            torch.maximum(torch.minimum(t1x, t2x), torch.minimum(t1y, t2y)),
            torch.minimum(t1z, t2z),
        )
        tf = torch.minimum(
            torch.minimum(torch.maximum(t1x, t2x), torch.maximum(t1y, t2y)),
            torch.maximum(t1z, t2z),
        )
        cands.append(torch.where((tn <= tf) & (tn > 0.0) & (tn < MISS_T), tn, MISS_T))
    return cands


def _fold(t: dict, counts: dict, o: V3, d: V3, shortlist=None, gated: bool = True):
    """(best t, best global index) of every ray; ``(MISS_T, -1)`` on a miss.

    The kernels fold walls, then boxes with a strict ``<``, then sphere
    chunks with ties going to the lower global index: the lexicographic
    minimum of (t, index), which this computes over stacks of candidates.
    Like the kernels, it folds a sphere chunk only where the chunk's gate
    lets the lane through. For unit directions the gate never drops a hit
    the fold would keep; a direction that left unit length after a grazing
    bounce can meet a sphere outside the gate, and there the gate decides.

    ``shortlist`` (the per-level chain) is ``(lists, n_list)``: each lane's
    tile's chunk order ``[..., n_c]`` and its length ``[...]`` (-1 for a
    dead tile); the lane walks those chunks in that order. Without it every
    lane walks all chunks in index order, as the whole-trace kernel does.
    With ``gated=False`` every lane folds every sphere, with no slab clip
    and no chunk gate (the brute-force fold of csrc/fold_flat.cu).
    """
    ox, oy, oz = o
    dx, dy, dz = d
    nd = dx.dim()
    n_s = counts["n_s"]

    def col(name, sl=slice(None)):
        return t[name][sl].view(-1, *([1] * nd))

    iv = (_srecip(dx), _srecip(dy), _srecip(dz))
    cands = _wall_box_candidates(t, counts, o, d, iv)
    if cands:
        bt, bi = _lexmin(torch.cat(cands), n_s)
    else:
        bt = torch.full_like(dx, MISS_T)
        bi = torch.full(dx.shape, -1, dtype=torch.int32, device=dx.device)
    if not n_s:
        return bt, bi

    oo = ox * ox + oy * oy + oz * oz
    do = dx * ox + dy * oy + dz * oz
    if gated:
        t0, t_ex, seg_ok = _slab_segment(t, o, iv)
    unroll = counts["unroll"]
    if shortlist is not None:
        lists, n_list = shortlist
        pos = torch.arange(unroll, device=dx.device).view(-1, *([1] * nd))
    for k in range(counts["n_c"]):
        if shortlist is None:
            c = k
            sl = slice(k * unroll, min((k + 1) * unroll, n_s))
            cx, cy, cz, cr2 = col("cx", sl), col("cy", sl), col("cz", sl), col("cr2", sl)
            base, real = sl.start, None
        else:
            c = lists[..., k]
            gi = c * unroll + pos  # [unroll, ...] global sphere indices
            real = gi < n_s
            gi = gi.clamp_max(n_s - 1)
            cx, cy, cz, cr2 = (t[n][gi] for n in ("cx", "cy", "cz", "cr2"))
            base = c * unroll
        s = dx * cx + dy * cy + dz * cz
        m = ox * cx + oy * cy + oz * cz
        b_half = do - s
        c_full = oo - 2.0 * m + cr2
        disc = b_half * b_half - c_full
        tt = -b_half - torch.sqrt(disc)  # NaN on a miss: fails the compare
        ok = (tt > 0.0) & (tt < MISS_T)
        if real is not None:
            ok = ok & real
        ct, ci = _lexmin(torch.where(ok, tt, MISS_T), base)
        win = (ci >= 0) & ((ct < bt) | ((ct == bt) & (ci < bi)))
        if gated:
            listed = seg_ok if shortlist is None else seg_ok & (k < n_list)
            t1 = torch.minimum(t_ex, bt)
            win = win & listed & _chunk_gate(t, counts["gate"], c, o, d, iv, oo, do, t0, t1)
        bt, bi = torch.where(win, ct, bt), torch.where(win, ci, bi)
    return bt, bi


def _attr_columns(t: dict, counts: dict) -> list:
    """The 14 per-primitive attribute columns (``[n_prim]`` each) of the
    fused table, in ``attribute_tables`` order: winner geometry g0..g5 (a
    sphere's center, radius, 0, 0; a wall's normal and corner; a box's min
    and max corners), then the 8 material columns."""
    none = t["cx"].new_zeros(counts["n_s"])
    geom = [torch.cat([t[sn] if sn else none, t[wn], t[bn]]) for sn, wn, bn in _GEOM_COLS]
    return geom + [t[name] for name in _MAT_COLS]


def _light_vector(t: dict) -> torch.Tensor:
    """Light scalars in the kernels' packing order: 6 per point light
    (position xyz, colour rgb), then 6 per sun (unit direction xyz, colour
    rgb)."""
    pt = torch.stack([t[n] for n in ("lpx", "lpy", "lpz", "lcr", "lcg", "lcb")], dim=1)
    sun = torch.stack([t[n] for n in ("sdx", "sdy", "sdz", "scr", "scg", "scb")], dim=1)
    return torch.cat([pt.reshape(-1), sun.reshape(-1)])


def _ls_vector(t: dict) -> torch.Tensor:
    """Light and sky scalars in the kernels' packing order: the lights
    (``_light_vector``), then the 10 sky scalars."""
    return torch.cat([_light_vector(t), t["sky"]])


def attribute_tables(scene: Scene) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernels' differentiable inputs: ``(attrs f32[n_prim, 14], ls
    f32[6 n_pt + 6 n_sun + 10])``.

    ``attrs`` holds each primitive's 6 geometry and 8 material columns
    (``_attr_columns`` order, the JAX package's parameter-gradient column
    order), ``ls`` the light and sky scalars (``_ls_vector`` order, the sun
    direction made unit). Built with autograd and without ``no_grad``, so
    cotangents of the two tables map back to the scene's leaves; their
    values equal the fused table's, which the kernels read.
    """
    s, wl, b = scene.spheres, scene.walls, scene.boxes
    geom = torch.cat([
        torch.cat([s.center, s.radius[:, None], s.radius.new_zeros((len(s), 2))], dim=1),
        torch.cat([wl.normal, wl.position], dim=1),
        torch.cat([b.minimum, b.maximum], dim=1),
    ])
    m = _packed_mat_tables(scene)
    attrs = torch.cat([geom, torch.stack([m[n] for n in _MAT_COLS], dim=1)], dim=1)
    return attrs, _ls_vector(_light_sky_tables(scene))


def _gather(cols, bi: torch.Tensor, hit: torch.Tensor) -> list:
    """The winner's entry of each per-primitive column (0 on a miss)."""
    gi = bi.clamp_min(0).long()
    return [
        torch.where(hit, col[gi], 0.0) if col.numel()
        else torch.zeros(hit.shape, dtype=torch.float32, device=hit.device)
        for col in cols
    ]


def _kinds(bi: torch.Tensor, hit: torch.Tensor, counts: dict):
    """(is sphere, is wall, is box) of each lane's winner."""
    wb, bb = counts["n_s"], counts["n_s"] + counts["n_w"]
    return hit & (bi < wb), hit & (bi >= wb) & (bi < bb), hit & (bi >= bb)


def _level(t: dict, counts: dict, o: V3, d: V3, w, is_last: bool, shortlist=None):
    """One level at fixed rays: fold (over ``shortlist``, see ``_fold``),
    regather, then ``_level_math``.

    Returns ``(t_out, index, increment V3, w_next, o_next, d_next)`` for
    every lane, alive or not; the caller masks the dead ones.
    """
    bt, bi = _fold(t, counts, o, d, shortlist)
    hit = bt < MISS_T
    acc = _gather(_attr_columns(t, counts), bi, hit)
    t_out, inc, w_next, o_next, d_next = _level_math(
        acc, o, d, w, bt, hit, *_kinds(bi, hit, counts), _ls_vector(t), counts,
        is_last,
    )
    return t_out, bi, inc, w_next, o_next, d_next


def _record_math(acc, t_sel, hit, is_s, is_w, is_b, o: V3, d: V3):
    """Winner t, hit point and normal from the gathered attributes.

    A differentiable function of ``acc`` (the 14 gathered planes) and the
    rays; ``t_sel`` (the fold's t, or the level's saved t) and the masks
    are constants. The sphere's t is recomputed in the full form where
    ``det > 0`` strictly (else the fold's t stands, so no miss or graze
    lane forms sqrt'(0)); the wall's where ``|denom| > 1e-12``.
    """
    ox, oy, oz = o
    dx, dy, dz = d
    g0, g1, g2, g3, g4, g5 = acc[:6]
    tt = t_sel
    bq = 2.0 * (dx * (ox - g0) + dy * (oy - g1) + dz * (oz - g2))
    cq = (ox - g0) * (ox - g0) + (oy - g1) * (oy - g1) + (oz - g2) * (oz - g2) - g3 * g3
    det = bq * bq - 4.0 * cq
    pos = det > 0.0
    t_s = 0.5 * (-bq - torch.sqrt(torch.where(pos, det, 1.0)))
    tt = torch.where(is_s & pos, t_s, tt)
    denom = dx * g0 + dy * g1 + dz * g2
    ok = torch.abs(denom) > 1e-12
    t_w = ((g3 - ox) * g0 + (g4 - oy) * g1 + (g5 - oz) * g2) / torch.where(ok, denom, 1.0)
    tt = torch.where(is_w & ok, t_w, tt)
    ivx, ivy, ivz = _srecip(dx), _srecip(dy), _srecip(dz)
    t_b = torch.maximum(
        torch.maximum(
            torch.minimum((g0 - ox) * ivx, (g3 - ox) * ivx),
            torch.minimum((g1 - oy) * ivy, (g4 - oy) * ivy),
        ),
        torch.minimum((g2 - oz) * ivz, (g5 - oz) * ivz),
    )
    tt = torch.where(is_b, t_b, tt)
    t_safe = torch.where(hit, tt, 1.0)
    hpx, hpy, hpz = ox + dx * t_safe, oy + dy * t_safe, oz + dz * t_safe

    inv_r = 1.0 / max_c(g3, 1e-12)
    hn = [(hpx - g0) * inv_r, (hpy - g1) * inv_r, (hpz - g2) * inv_r]
    hn = [torch.where(is_w, gk, h) for h, gk in zip(hn, (g0, g1, g2))]
    tx = (torch.where(dx >= 0, g0, g3) - ox) * ivx
    ty = (torch.where(dy >= 0, g1, g4) - oy) * ivy
    tz = (torch.where(dz >= 0, g2, g5) - oz) * ivz
    bx = (tx >= ty) & (tx >= tz)
    by = ~bx & (ty >= tz)
    bz = ~bx & ~by
    hn = [
        torch.where(is_b, torch.where(bk, -torch.sign(dk), 0.0), h)
        for h, bk, dk in zip(hn, (bx, by, bz), (dx, dy, dz))
    ]
    hnx = torch.where(hit, hn[0], 0.0)
    hny = torch.where(hit, hn[1], 0.0)
    hnz = torch.where(hit, hn[2], 1.0)
    return tt, V3(hpx, hpy, hpz), V3(hnx, hny, hnz)


def _shade(mats, hp: V3, hn: V3, view: V3, lights: torch.Tensor, n_pt: int, n_sun: int) -> V3:
    """Blinn-Phong colour at each hit point: ``color * (light sum +
    ambient)``, the light sum over ``n_pt`` point lights and ``n_sun`` suns
    (``lights`` in ``_light_vector`` order; the sky scalars may follow).
    ``mats`` are the 8 gathered material planes (colour rgb, ambient,
    metallic, diffuse, specular, exponent), ``view`` the direction towards
    the eye (``-d``)."""
    hpx, hpy, hpz = hp
    hnx, hny, hnz = hn
    colr, colg, colb, amb, _, dif, spe, exq = mats
    vwx, vwy, vwz = view

    def light_terms(lx, ly, lz):
        diffuse = max_c(lx * hnx + ly * hny + lz * hnz, 0.0)
        hvx, hvy, hvz = vwx + lx, vwy + ly, vwz + lz
        n2 = hvx * hvx + hvy * hvy + hvz * hvz
        hsc = torch.rsqrt(torch.where(n2 > 1e-12, n2, 1.0))
        base = max_c((hvx * hnx + hvy * hny + hvz * hnz) * hsc, 0.0)
        specular = torch.where(
            base > 0.0, torch.exp(exq * torch.log(torch.where(base > 0.0, base, 1.0))), 0.0
        )
        return diffuse * dif + specular * spe

    ir = torch.zeros_like(hpx)
    ig = torch.zeros_like(hpx)
    ib = torch.zeros_like(hpx)
    for li in range(n_pt):
        px, py, pz, cr, cg, cb = lights[6 * li:6 * li + 6]
        ldx = px - hpx
        ldy = py - hpy
        ldz = pz - hpz
        n2 = ldx * ldx + ldy * ldy + ldz * ldz
        inv = torch.rsqrt(max_c(n2, 1e-12))
        term = light_terms(ldx * inv, ldy * inv, ldz * inv)
        ir = ir + cr * term
        ig = ig + cg * term
        ib = ib + cb * term
    for si in range(n_sun):
        sx, sy, sz, cr, cg, cb = lights[6 * (n_pt + si):6 * (n_pt + si) + 6]
        term = light_terms(sx, sy, sz)
        ir = ir + cr * term
        ig = ig + cg * term
        ib = ib + cb * term
    return V3(colr * (ir + amb), colg * (ig + amb), colb * (ib + amb))


def _sky(dz: torch.Tensor, sky: torch.Tensor) -> V3:
    """The sky seen along directions of z component ``dz``: the ground
    colour below the horizon, a power gradient from horizon to zenith above
    (``sky``: the 10 scalars of ``_sky_vector``)."""
    z = dz
    grad = torch.where(
        z > 0.0, torch.exp(sky[9] * torch.log(torch.where(z > 0.0, z, 1.0))), 0.0
    )
    return V3(*(
        torch.where(z < 0.0, sky[6 + k], sky[k] + (sky[3 + k] - sky[k]) * grad)
        for k in range(3)
    ))


def _unit(v: V3) -> V3:
    """``v * rsqrt(v . v)``; a vector of squared length 1e-12 or less stays
    as it is (a box's face normal where the ray runs along the face)."""
    n2 = v.x * v.x + v.y * v.y + v.z * v.z
    return v * torch.rsqrt(torch.where(n2 > 1e-12, n2, 1.0))


def _bounce(hp: V3, hn: V3, d: V3) -> tuple[V3, V3]:
    """The mirror bounce at a hit, the upstream's ``reflect``: the next ray
    leaves ``hp`` by ``REFLECT_EPS`` along the unit normal n^ in the
    direction ``d^ - 2 (d^ . n^) n^``, with d^ and n^ the incoming direction
    and the normal made unit (``_unit``). Taking both as unit keeps |d| at 1
    level after level: the record's float32 normal is off unit by up to
    ~4e-5, and ``d - 2 (d . n) n`` grew |d| at each grazing hit until the
    shading overflowed. Returns ``(o_next, d_next)``."""
    dh, nh = _unit(d), _unit(hn)
    dn2 = 2.0 * (dh.x * nh.x + dh.y * nh.y + dh.z * nh.z)
    return hp + nh * REFLECT_EPS, dh - nh * dn2


def _level_math(acc, o: V3, d: V3, w, t_sel, hit, is_s, is_w, is_b,
                ls: torch.Tensor, counts: dict, is_last: bool):
    """One level's differentiable math at fixed selections: winner record
    (``_record_math``), Blinn-Phong shading (``_shade``), sky (``_sky``),
    accumulator increment and mirror bounce.

    A function of the gathered attributes ``acc``, the rays, the throughput
    ``w`` and the light/sky scalars ``ls``; ``t_sel`` and the masks are
    constants. The forward (``_level``) and the backward's plain version
    (``trace_whole_bwd_reference``) both run it, so the gradient is that
    of the forward's own arithmetic. Returns ``(t_out, increment V3,
    w_next, o_next V3, d_next V3)``.
    """
    dx, dy, dz = d
    tt, hp, hn = _record_math(acc, t_sel, hit, is_s, is_w, is_b, o, d)
    met = acc[10]
    n_pt, n_sun = counts["n_pt"], counts["n_sun"]
    local = _shade(acc[6:], hp, hn, V3(-dx, -dy, -dz), ls, n_pt, n_sun)
    sk = _sky(dz, ls[6 * (n_pt + n_sun):])

    hc = local if is_last else local * (1.0 - met)
    inc = V3.where(hit & (w > 0.0), hc, sk) * w
    t_out = torch.where(hit, tt, t_sel)
    w_next = w * torch.where(hit, met, 0.0)
    o_b, d_b = _bounce(hp, hn, d)
    o_next, d_next = V3.where(hit, o_b, o), V3.where(hit, d_b, d)
    return t_out, inc, w_next, o_next, d_next


def trace_whole_reference(tables: FusedTables, o: V3, d: V3, w: torch.Tensor,
                          depth: int, emit_res: bool = False):
    """Plain PyTorch version of ``trace_whole``: the same outputs for the
    same inputs, on any device, for any scene size and depth (it folds
    every primitive, where the kernel gates whole chunks away; the gates
    only skip chunks that cannot win, so the fold is the same)."""
    t, counts = tables.cols, tables.counts
    acc = V3(torch.zeros_like(w), torch.zeros_like(w), torch.zeros_like(w))
    ts, idxs, res = [], [], []
    with torch.no_grad():
        for k in range(depth + 1):
            if emit_res and k >= 1:
                res.append(torch.stack([*o, *d, w]))
            alive = w > 0.0
            t_k, i_k, inc, w_next, o_next, d_next = _level(
                t, counts, o, d, w, is_last=k == depth
            )
            ts.append(torch.where(alive, t_k, MISS_T))
            idxs.append(torch.where(alive, i_k, -1))
            acc = acc + V3.where(alive, inc, V3(*(torch.zeros_like(w),) * 3))
            w = torch.where(alive, w_next, w)
            o, d = V3.where(alive, o_next, o), V3.where(alive, d_next, d)
    out = (acc, torch.stack(ts), torch.stack(idxs))
    if emit_res:
        out += (torch.stack(res) if res else w.new_zeros((0, 7, *w.shape)),)
    return out


def whole_grid(shape, tile=None, tables: FusedTables | None = None) -> tuple:
    """``((H, W), (rows, cols))``: the ``[H, W]`` view in which the
    whole-trace kernels take planes of ``shape``, and the pixels of a
    block's tile (a power of two of columns; a warp is 32 consecutive
    threads of a tile). ``WHOLE_TILE`` over ``shape``'s last dimension
    where its ragged tiles idle at most 1/16 of the lanes (and there are at
    most 65535 rows of tiles, the launch grid's y), else (1, 256) strips
    over the flat planes (1-D, one-row and narrow planes). The strips too
    for ``tables`` whose chunks hold fewer than ``PAIR_MIN_UNROLL`` spheres
    (sprint3, the demo): their lanes fold alone, and whole rows write
    their planes faster (PERF.md). ``tile`` forces a tile; (1, 256) is the
    flat layout."""
    from raytracer_tpu_torch.ops import cuda_level

    n = 1
    for s in shape:
        n *= int(s)
    if tile is None:
        lane_route = tables is not None and tables.counts["unroll"] < cuda_level.PAIR_MIN_UNROLL
        tile = (1, _WHOLE_BLOCK) if lane_route else WHOLE_TILE
    tile = tuple(tile)
    if tile != (1, _WHOLE_BLOCK) and len(shape) >= 2 and shape[-1]:
        tr, tc = tile
        w = int(shape[-1])
        h = n // w
        th = -(-h // tr)
        if h > 1 and th <= 65535 and th * tr * (-(-w // tc) * tc) - n <= n // 16:
            return (h, w), (tr, tc)
    return (1, n), (1, _WHOLE_BLOCK)


def whole_pair_reference(tables: FusedTables, o: V3, d: V3, w: torch.Tensor, depth: int,
                         emit_res: bool = False, k_min: int | None = None, tile=None):
    """Plain mirror of ``trace_whole`` as csrc/trace_whole.cu runs it: the
    outputs of ``trace_whole_reference`` (equal to them bit for bit), and a
    list with each level's fold work by route.

    Each level folds through ``cuda_level.pair_fold`` over the identity
    chunk list in the kernel's lane layout (``whole_grid`` of the planes
    and ``tables``, or ``tile``):
    a warp's lanes gate each chunk against their segments, and where fewer
    than ``k_min`` (default ``cuda_level.PAIR_MIN_LANES``) of them pass,
    the warp folds it for them one ray at a time; then the regather,
    ``_level_math`` and the masks of dead lanes, as ``trace_whole_reference``.
    """
    from raytracer_tpu_torch.ops import cuda_level

    if k_min is None:
        k_min = cuda_level.PAIR_MIN_LANES
    t, counts = tables.cols, tables.counts
    shape = w.shape
    (h, wd), tile = whole_grid(shape, tile, tables)
    o, d = V3(*(c.reshape(h, wd) for c in o)), V3(*(c.reshape(h, wd) for c in d))
    w = w.reshape(h, wd)
    zero = torch.zeros_like(w)
    acc = V3(zero, zero, zero)
    ts, idxs, res, works = [], [], [], []
    with torch.no_grad():
        for k in range(depth + 1):
            if emit_res and k >= 1:
                res.append(torch.stack([*o, *d, w]))
            alive = w > 0.0
            bt, bi, work = cuda_level.pair_fold(tables, None, o, d, w, k_min, tile)
            works.append(work)
            hit = bt < MISS_T
            attrs = _gather(_attr_columns(t, counts), bi, hit)
            t_k, inc, w_next, o_next, d_next = _level_math(
                attrs, o, d, w, bt, hit, *_kinds(bi, hit, counts), _ls_vector(t), counts,
                k == depth,
            )
            ts.append(torch.where(alive, t_k, MISS_T))
            idxs.append(torch.where(alive, bi, -1))
            acc = acc + V3.where(alive, inc, V3(zero, zero, zero))
            w = torch.where(alive, w_next, w)
            o, d = V3.where(alive, o_next, o), V3.where(alive, d_next, d)
    out = (V3(*(c.reshape(shape) for c in acc)), torch.stack(ts).reshape(depth + 1, *shape),
           torch.stack(idxs).reshape(depth + 1, *shape))
    if emit_res:
        out += (torch.stack(res).reshape(depth, 7, *shape) if res
                else zero.new_zeros((0, 7, *shape)),)
    return out, works


@dataclasses.dataclass(frozen=True)
class Residuals:
    """What the backward needs of a forward trace: level 0's input rays and
    throughput (the caller's planes), each level's selections ``t``
    f32[depth+1, ...] and ``i`` i32[depth+1, ...], and ``res``
    f32[depth, 7, ...], the input rays and throughput of levels 1..depth as
    ``trace_whole(..., emit_res=True)`` writes them."""

    o: V3
    d: V3
    w: torch.Tensor
    t: torch.Tensor
    i: torch.Tensor
    res: torch.Tensor

    def level(self, k: int):
        """``(o V3, d V3, w)`` entering level ``k``."""
        if k == 0:
            return self.o, self.d, self.w
        r = self.res[k - 1]
        return V3(r[0], r[1], r[2]), V3(r[3], r[4], r[5]), r[6]


def trace_level_bwd_reference(tables: FusedTables, attrs: torch.Tensor, ls: torch.Tensor,
                              o: V3, d: V3, w: torch.Tensor, t_k: torch.Tensor,
                              i_k: torch.Tensor, ct_acc: V3, ct_next, is_last: bool,
                              sums: tuple):
    """The backward of one level at fixed selections, the plain version of
    ``cuda_level.trace_level_bwd`` (csrc/trace_level_bwd.cu) and one level
    of ``trace_whole_bwd_reference``: the cotangents of the level's input
    rays and throughput, ``[ct_o xyz, ct_d xyz, ct_w]``.

    It regathers each alive lane's winner from ``attrs`` by the saved index
    ``i_k``, replays ``_level_math`` from the level's input rays (o, d),
    throughput ``w`` and saved t ``t_k`` with autograd, and takes the
    gradient of the image cotangent ``ct_acc`` plus ``ct_next``, the
    cotangents of the level's outputs (the next rays and throughput, in the
    same order; ``None`` after the last level). Lanes with ``w == 0`` are
    dead there: their cotangents pass through and they add nothing. The
    cotangents of ``attrs`` and ``ls`` are added into ``sums``, a pair of
    float64 tensors of their shapes (one ``index_add_``, so the rounding
    does not grow with the number of lanes that hit one primitive).
    """
    counts = tables.counts
    ct7 = list(ct_next) if ct_next is not None else [torch.zeros_like(w) for _ in range(7)]
    alive = w > 0.0
    if not bool(alive.any()):
        return ct7
    attrs = attrs.detach()
    ls = ls.detach().requires_grad_(True)
    i_a = i_k[alive]
    hit = i_a >= 0
    gi = i_a.clamp_min(0).long()
    with torch.enable_grad():
        rays = [c[alive].detach().requires_grad_(True) for c in (*o, *d, w)]
        rows = attrs[gi] if attrs.shape[0] else attrs.new_zeros((gi.numel(), 14))
        rows.requires_grad_(True)
        acc = [torch.where(hit, col, 0.0) for col in rows.unbind(1)]
        _, inc, w_next, o_next, d_next = _level_math(
            acc, V3(*rays[:3]), V3(*rays[3:6]), rays[6], t_k[alive],
            hit, *_kinds(i_a, hit, counts), ls, counts, is_last,
        )
        outs = (*inc, w_next, *o_next, *d_next)
        cts = (*(c[alive] for c in ct_acc), *(c[alive] for c in (ct7[6], *ct7[:6])))
        grads = torch.autograd.grad(outs, (*rays, rows, ls), cts, allow_unused=True)
    for j in range(7):
        ct7[j] = ct7[j].masked_scatter(alive, grads[j])
    if grads[7] is not None and attrs.shape[0]:
        sums[0].index_add_(0, gi[hit], grads[7][hit].double())
    if grads[8] is not None:
        sums[1].add_(grads[8].double())
    return ct7


def trace_whole_bwd_reference(tables: FusedTables, attrs: torch.Tensor,
                              ls: torch.Tensor, levels: Residuals,
                              ct_acc: V3, depth: int):
    """Plain PyTorch version of ``trace_whole_bwd``: the cotangents of
    ``trace_whole``'s rgb with respect to its inputs at fixed selections.

    ``trace_level_bwd_reference`` for k = depth..0, each level's ray and
    throughput cotangents feeding level k-1's; the table cotangents are
    summed in float64. ``attrs`` and ``ls`` are ``attribute_tables``'
    values for the scene of ``tables``.

    Returns ``(ct_o V3, ct_d V3, ct_w, ct_attrs f32[n_prim, 14], ct_ls)``.
    """
    sums = (torch.zeros(attrs.shape, dtype=torch.float64, device=attrs.device),
            torch.zeros(ls.shape, dtype=torch.float64, device=ls.device))
    ct7 = None
    for k in reversed(range(depth + 1)):
        o, d, w = levels.level(k)
        ct7 = trace_level_bwd_reference(tables, attrs, ls, o, d, w, levels.t[k],
                                        levels.i[k], ct_acc, ct7, k == depth, sums)
    return V3(*ct7[:3]), V3(*ct7[3:6]), ct7[6], sums[0].float(), sums[1].float()


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------


def _check_planes(planes, shape, device, name="trace_whole", dtype=torch.float32):
    for p in planes:
        if p.device != device or p.dtype != dtype:
            raise ValueError(
                f"{name} takes {str(dtype)[6:]} planes on {device}, got "
                f"{p.dtype} on {p.device}"
            )
        if p.shape != shape or not p.is_contiguous():
            raise ValueError(
                f"{name} takes contiguous planes of shape {tuple(shape)}, "
                f"got {tuple(p.shape)} (contiguous={p.is_contiguous()})"
            )


def _check_table(tables: FusedTables, depth: int, dev, name: str):
    """What every kernel needs of the scene table and the depth on CUDA."""
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got {dev}")
    if tables.packed.device != dev or not tables.packed.is_contiguous():
        raise ValueError("the packed scene table must be contiguous on the rays' device")
    if depth < 0:
        raise ValueError(f"depth {depth} is negative")


def _check_kernel_class(tables: FusedTables, depth: int, dev, name: str):
    """What both whole-trace kernels need on CUDA: their shared tables fit
    the shared memory a block can have (``whole_smem_bytes``,
    ``whole_bwd_smem_bytes``). Any chunk count and depth run;
    ``in_fused_class`` is where ``trace_soa`` sends them."""
    _check_table(tables, depth, dev, name)
    need = max(whole_smem_bytes(tables), whole_bwd_smem_bytes(tables))
    if need > _SMEM_MAX:
        raise ValueError(
            f"scene tables ({need} bytes of shared memory) exceed the {_SMEM_MAX} "
            f"bytes a block of {name} can have"
        )


def whole_smem_bytes(tables: FusedTables) -> int:
    """Dynamic shared bytes of a ``trace_whole`` launch: the spheres as
    float4, then the table without its spheres and materials (csrc
    trace_common.cuh's ``tab_level_shared``); for scenes of one-sphere
    chunks (the kernel's lane route) the packed table as it is."""
    from raytracer_tpu_torch.ops import cuda_level

    c = tables.counts
    if c["unroll"] < cuda_level.PAIR_MIN_UNROLL:
        return tables.smem_bytes
    n_prim = c["n_s"] + c["n_w"] + c["n_b"]
    return 4 * (tables.packed.numel() - 8 * n_prim - c["n_s"])


def whole_bwd_smem_bytes(tables: FusedTables) -> int:
    """Dynamic shared bytes of a ``trace_whole_bwd`` launch: the table
    without its materials, the light and sky sums (each lane's, for at most
    ``_LANE_LS_MAX`` of them; else one row), and the float32 sums of the
    hot attribute rows: walls and boxes, and spheres in scenes of at most
    ``_SHARED_SPHERES_MAX`` (csrc/trace_whole_bwd.cu)."""
    c = tables.counts
    n_prim = c["n_s"] + c["n_w"] + c["n_b"]
    n_ls = 6 * (c["n_pt"] + c["n_sun"]) + 10
    ls = n_ls * _WHOLE_BLOCK if n_ls <= _LANE_LS_MAX else n_ls
    rows = n_prim - (0 if c["n_s"] <= _SHARED_SPHERES_MAX else c["n_s"])
    return 4 * (tables.packed.numel() - 8 * n_prim + ls + 14 * rows)


def _table_args(tables: FusedTables, depth: int) -> tuple:
    c = tables.counts
    return (
        tables.packed.data_ptr(), tables.packed.numel(),
        c["n_s"], c["unroll"], c["n_w"], c["n_b"], c["n_pt"], c["n_sun"],
        c["gate"], depth,
    )


def _raise_on(err: int, lib, name: str):
    if err:
        raise RuntimeError(
            f"{name} launch failed: CUDA error {err} "
            f"({getattr(lib, name + '_error_string')(err).decode()})"
        )


def trace_whole(tables: FusedTables, o: V3, d: V3, w: torch.Tensor, depth: int,
                emit_res: bool = False):
    """Every bounce level of a ray tile: ``(rgb V3, t f32[depth+1, ...],
    index i32[depth+1, ...])``, and with ``emit_res`` also ``res``
    f32[depth, 7, ...], the input rays and throughput of levels 1..depth
    (``Residuals.res``; level 0's are the caller's planes).

    Inputs: ray origins ``o``, unit directions ``d`` and throughput ``w``,
    seven contiguous float32 planes of one shape on one device. On CPU
    tensors this is ``trace_whole_reference``; on CUDA tensors it launches
    the kernel on the current stream, in the lane layout of
    ``whole_grid``, or raises.
    """
    dev, shape = w.device, w.shape
    _check_planes((*o, *d, w), shape, dev)
    if dev.type == "cpu":
        return trace_whole_reference(tables, o, d, w, depth, emit_res)
    _check_kernel_class(tables, depth, dev, "trace_whole")
    rgb = [torch.empty(shape, dtype=torch.float32, device=dev) for _ in range(3)]
    t_out = torch.empty((depth + 1, *shape), dtype=torch.float32, device=dev)
    i_out = torch.empty((depth + 1, *shape), dtype=torch.int32, device=dev)
    res = torch.empty((depth, 7, *shape), dtype=torch.float32, device=dev) if emit_res else None
    if w.numel():
        (h, wd), (tr, tc) = whole_grid(shape, tables=tables)
        lib = _build.load("trace_whole", _SIGNATURES)
        err = lib.trace_whole_launch(
            *_table_args(tables, depth), int(emit_res),
            *(p.data_ptr() for p in (*o, *d, w)),
            *(p.data_ptr() for p in rgb), t_out.data_ptr(), i_out.data_ptr(),
            res.data_ptr() if emit_res else None,
            h, wd, tr, tc, torch.cuda.current_stream(dev).cuda_stream,
        )
        _raise_on(err, lib, "trace_whole")
        profiler.count_launch("trace_whole")
    out = (V3(*rgb), t_out, i_out)
    return out + (res,) if emit_res else out


def trace_whole_bwd(tables: FusedTables, attrs: torch.Tensor, ls: torch.Tensor,
                    levels: Residuals, ct_acc: V3, depth: int):
    """The whole-trace backward: ``(ct_o V3, ct_d V3, ct_w, ct_attrs
    f32[n_prim, 14], ct_ls)``, the cotangents of ``trace_whole``'s inputs
    and of the attribute and light/sky tables for the image cotangent
    ``ct_acc``, at the selections and residuals ``levels`` of its forward.

    On CPU tensors this is ``trace_whole_bwd_reference``; on CUDA tensors
    it launches csrc/trace_whole_bwd.cu on the current stream, or raises.
    The kernel reads the scene from ``tables.packed``; ``attrs`` and ``ls``
    only fix the shapes of its outputs. The kernel adds the table
    cotangents into float64 tables, returned as float32.
    """
    dev, shape = levels.w.device, levels.w.shape
    n_prim = tables.counts["n_s"] + tables.counts["n_w"] + tables.counts["n_b"]
    n_ls = 6 * (tables.counts["n_pt"] + tables.counts["n_sun"]) + 10
    name = "trace_whole_bwd"
    _check_planes((*levels.o, *levels.d, levels.w, *ct_acc), shape, dev, name)
    _check_planes((levels.t,), (depth + 1, *shape), dev, name)
    _check_planes((levels.i,), (depth + 1, *shape), dev, name, torch.int32)
    _check_planes((levels.res,), (depth, 7, *shape), dev, name)
    _check_planes((attrs,), (n_prim, 14), dev, name)
    _check_planes((ls,), (n_ls,), dev, name)
    if dev.type == "cpu":
        return trace_whole_bwd_reference(tables, attrs, ls, levels, ct_acc, depth)
    _check_kernel_class(tables, depth, dev, name)
    cts = [torch.empty(shape, dtype=torch.float32, device=dev) for _ in range(7)]
    ga = torch.zeros((n_prim, 14), dtype=torch.float64, device=dev)
    gl = torch.zeros((n_ls,), dtype=torch.float64, device=dev)
    n = levels.w.numel()
    if n:
        lib = _build.load(name, _BWD_SIGNATURES)
        err = lib.trace_whole_bwd_launch(
            *_table_args(tables, depth),
            *(p.data_ptr() for p in (*levels.o, *levels.d, levels.w)),
            levels.res.data_ptr(), levels.t.data_ptr(), levels.i.data_ptr(),
            *(p.data_ptr() for p in ct_acc), *(p.data_ptr() for p in cts),
            ga.data_ptr(), gl.data_ptr(), n, torch.cuda.current_stream(dev).cuda_stream,
        )
        _raise_on(err, lib, name)
        profiler.count_launch("trace_whole_bwd")
    return V3(*cts[:3]), V3(*cts[3:6]), cts[6], ga.float(), gl.float()

# C signatures of the exported functions of csrc/trace_whole.cu and
# csrc/trace_whole_bwd.cu.
_TABLE_ARGTYPES = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_int] * 8
_SIGNATURES = {
    "trace_whole_launch": (
        ctypes.c_int,
        _TABLE_ARGTYPES + [ctypes.c_int] + [ctypes.c_void_p] * 13
        + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    ),
    "trace_whole_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}
_BWD_SIGNATURES = {
    "trace_whole_bwd_launch": (
        ctypes.c_int,
        _TABLE_ARGTYPES + [ctypes.c_void_p] * 22 + [ctypes.c_longlong, ctypes.c_void_p],
    ),
    "trace_whole_bwd_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}
