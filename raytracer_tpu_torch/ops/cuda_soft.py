"""The soft renderer's levels: one soft reflection level per launch.

``soft_level`` launches csrc/soft_level.cu, one thread per ray. Each thread
finds its anchor depth ``t_ref`` (the front depth of the primitives with
coverage above 0.3), then streams every primitive into the composite carry
(spheres in chunks of ``SOFT_CHUNK``, then walls, then boxes): the softmax
weight sum ``s``, the weighted payload sums and the log-transmittance; then
normalises, blends over the sky, adds ``w * local`` into the accumulator and
writes the expected-surface reflection ray and its throughput ``w_next``.
With ``emit_res`` it also writes ``t_ref`` and the carry, which the
backward reads instead of running the two sphere passes again.
``soft_level_bwd`` launches csrc/soft_level_bwd.cu: the adjoint of the
level, derived by hand, at the saved carry.

Both kernels keep the small table (walls, boxes, lights, sky, tau) in
shared memory and stream the sphere columns and chunk gates through a ring
of two tiles of whole chunks, so any number of spheres runs
(``soft_launch_plan`` gives a launch's tiles and shared memory). A warp
culls each tile's chunks against the bounds of its rays before each lane's
exact gate. On the bounce levels of large scenes ``soft_levels`` launches
the lanes in the order of ``soft_lane_order`` (rays close in origin and
direction together, so a warp's lanes reach the same chunks); the order
changes no lane's arithmetic, and the backward reuses it.

A sphere chunk is skipped for a lane that its gate rejects (the
counterpart of the JAX package's ``_chunk_reachable``, without its
``w > 0`` term: a dead lane composites every primitive, as the JAX
package's XLA path does). A rejected chunk's coverage sigmoids underflow to
exactly 0 in float32, so its contributions and all their cotangents are
exactly 0, and skipping it changes nothing. The plain versions here
(``soft_level_reference``, ``soft_level_bwd_reference``) do not gate: they
run every chunk for every lane, so the kernels against them is the check
that the gates are exact. Kernels and plain versions alike skip the
padding spheres (index ``n_s`` and up, centre 1e8). That is a deliberate
difference from the JAX package, which keeps them in its sums: a pad's
coverage is 0 on almost every ray, but on a ray within ~2.6e-4 rad of a
pad's direction float32 rounding of its discriminant (at 3e16, one ulp is
2e9) can lift it to 0.5 or 1, and the pad then hides what lies behind it
there (tests/test_torch_soft_tiles.py pins such a ray).

Tables. ``soft_tables`` is the counterpart of ``_soft_param_arrays``: every
scalar the level reads, as named 1-D arrays (JAX's keys and sizes,
placeholders of size 1 for absent groups included), packed in one float32
vector in ``_PACK`` order, which csrc/soft_common.cuh mirrors. It is built
with autograd, so the cotangent of the packed vector, which the backward
returns, reaches the scene's leaves and the temperatures. The spheres are
padded to whole chunks with never-hit spheres (centre 1e8). The chunk gates
(``soft_gate_tables``, the counterpart of ``_soft_gate_arrays``) carry no
gradient.

Every per-ray quantity is a contiguous float32 ``[rows, W]`` plane.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch
from torch.autograd.function import once_differentiable

from raytracer_tpu_torch.core.types import Scene
from raytracer_tpu_torch.core.v3 import V3
from raytracer_tpu_torch.diff.soft import (
    ALPHA_REF,
    FAR,
    _box_alpha_t_scalar,
    _normalized,
    _shade_point_scalar,
    _sphere_alpha_t_scalar,
    _wall_alpha_t_scalar,
)
from raytracer_tpu_torch.ops import _build
from raytracer_tpu_torch.ops.cuda_fold import (
    GATE_AABB,
    GATE_SPHERE,
    _check_planes,
    _raise_on,
    _srecip,
    max_c,
)
from raytracer_tpu_torch.ops.cuda_level import _ptrs, _stream
from raytracer_tpu_torch.ops.trace import REFLECT_EPS, _wall_tables

__all__ = [
    "SOFT_CHUNK",
    "SoftTables",
    "soft_tables",
    "soft_gate_tables",
    "chunk_reachable",
    "soft_level_reference",
    "soft_level",
    "soft_levels",
    "soft_level_bwd_reference",
    "soft_level_bwd",
    "soft_levels_bwd",
    "soft_launch_plan",
    "soft_lane_order",
]

SOFT_CHUNK = 8  # spheres per chunk: the table's padding quantum and the gate's unit
# Gate margins. 1 / (1 + exp(-x)) is exactly 0 in float32 below -88.72 (exp
# overflows; above it the quotient is a denormal, not 0). A line at distance
# rho from a centre has coverage argument (r^2 - rho^2) / (2 r tau), so the
# radius inflation r_eff^2 = r^2 + GATE_SIG_MARGIN r tau puts it at
# -GATE_SIG_MARGIN / 2 at the gate: 256 gives -128, 1.44x past the underflow.
# (The JAX package's 128 gives -64, where the exp form is 1.6e-28: exact
# only for a sigmoid that underflows earlier.) The front sigmoid's argument
# is t / tau itself: 128 there.
GATE_SIG_MARGIN = 256.0
GATE_T_MARGIN = 128.0
GATE_PAD = 1e-2  # absolute inflation of the chunk bounds (float32 drift)
_BIG = 1e30
# The largest value below 1 that log1p(-alpha) sees: float32(1 - 1e-7).
_ALPHA_MAX = 1.0 - 1e-7

SPH_KEYS = ("cx", "cy", "cz", "r", "colr", "colg", "colb", "amb", "kd", "ks", "exp", "met")
WALL_GEO_KEYS = ("nx", "ny", "nz", "rx", "ry", "rz", "ux", "uy", "uz", "px", "py", "pz",
                 "dplane", "length", "width")
MAT_KEYS = ("colr", "colg", "colb", "amb", "kd", "ks", "exp", "met")
BOX_GEO_KEYS = ("mnx", "mny", "mnz", "mxx", "mxy", "mxz")
PT_KEYS = ("l_px", "l_py", "l_pz", "l_cr", "l_cg", "l_cb")
SUN_KEYS = ("l_sdx", "l_sdy", "l_sdz", "l_scr", "l_scg", "l_scb")
GATE_KEYS = ("gcx", "gcy", "gcz", "gg", "gr2", "gsm", "galx", "galy", "galz",
             "gahx", "gahy", "gahz")

# (key, count key) of each packed array, in packing order; a group's array
# holds n_s_pad spheres or max(n, 1) of the other items.
_PACK = (
    tuple(("s_" + k, "n_s_pad") for k in SPH_KEYS)
    + tuple(("w_" + k, "nw1") for k in WALL_GEO_KEYS + MAT_KEYS)
    + tuple(("b_" + k, "nb1") for k in BOX_GEO_KEYS + MAT_KEYS)
    + tuple((k, "np1") for k in PT_KEYS)
    + tuple((k, "nu1") for k in SUN_KEYS)
    + (("z_sky", "sky"), ("z_tau", "one"), ("z_tau_z", "one"))
)


def _counts(scene: Scene) -> dict:
    n_s = len(scene.spheres)
    n_s_pad = max(-(-n_s // SOFT_CHUNK) * SOFT_CHUNK, SOFT_CHUNK)
    n_chunks = n_s_pad // SOFT_CHUNK
    c = {
        "n_s": n_s, "n_s_pad": n_s_pad, "n_chunks": n_chunks,
        "n_w": len(scene.walls), "n_b": len(scene.boxes),
        "n_pt": scene.lights.point_position.shape[0],
        "n_sun": scene.lights.sun_color.shape[0],
        "gate": GATE_AABB if n_chunks >= 2 else GATE_SPHERE,
    }
    c.update(nw1=max(c["n_w"], 1), nb1=max(c["n_b"], 1), np1=max(c["n_pt"], 1),
             nu1=max(c["n_sun"], 1), sky=10, one=1)
    return c


@dataclasses.dataclass(frozen=True)
class SoftTables:
    """A scene packed for the soft kernels: ``packed``, the float32 vector
    of every ``_PACK`` array, and ``counts``."""

    packed: torch.Tensor
    counts: dict

    @property
    def layout(self) -> dict:
        """``{key: (offset, size)}`` of each array in ``packed``."""
        out, off = {}, 0
        for key, size_key in _PACK:
            out[key] = (off, self.counts[size_key])
            off += self.counts[size_key]
        return out

    def arrays(self, packed: torch.Tensor | None = None) -> dict:
        """``{key: 1-D view}`` of ``packed`` (by default this table's)."""
        packed = self.packed if packed is None else packed
        return {k: packed[off:off + n] for k, (off, n) in self.layout.items()}


def _pad_to(x: torch.Tensor, n: int, fill: float) -> torch.Tensor:
    pad = n - x.shape[0]
    return torch.cat([x, x.new_full((pad,), fill)]) if pad > 0 else x


def _one(x: torch.Tensor) -> torch.Tensor:
    """``x``, or one 0 where it is empty (the placeholder of an absent group)."""
    return x if x.shape[0] else x.new_zeros((1,))


def soft_tables(scene: Scene, tau, tau_z) -> SoftTables:
    """The level's scalars, packed (module docstring); the counterpart of
    ``_soft_param_arrays``. Built with autograd: call it under ``no_grad``
    when no gradient is wanted. ``tau`` and ``tau_z`` are floats or 0-d
    tensors; the sun directions are made unit here."""
    counts = _counts(scene)
    dev = scene.spheres.radius.device
    s, m = scene.spheres, scene.spheres.material
    cols = {
        "cx": (s.center[:, 0], 1e8), "cy": (s.center[:, 1], 1e8),
        "cz": (s.center[:, 2], 1e8), "r": (s.radius, 1e-3),
        "colr": (m.color[:, 0], 0.0), "colg": (m.color[:, 1], 0.0),
        "colb": (m.color[:, 2], 0.0), "amb": (m.ambient, 0.0),
        "kd": (m.diffuse, 0.0), "ks": (m.specular, 0.0),
        "exp": (m.specular_exponent, 1.0), "met": (m.metallic, 0.0),
    }
    arrs = {"s_" + k: _pad_to(v, counts["n_s_pad"], fill) for k, (v, fill) in cols.items()}

    def mats(prefix, mat):
        return {prefix + k: _one(v) for k, v in zip(MAT_KEYS, (
            mat.color[:, 0], mat.color[:, 1], mat.color[:, 2], mat.ambient,
            mat.diffuse, mat.specular, mat.specular_exponent, mat.metallic))}

    wt = _wall_tables(scene.walls)
    arrs.update({"w_" + k: _one(wt[k]) for k in WALL_GEO_KEYS})
    arrs.update(mats("w_", scene.walls.material))
    b = scene.boxes
    arrs.update({"b_" + k: _one(v) for k, v in zip(BOX_GEO_KEYS, (
        b.minimum[:, 0], b.minimum[:, 1], b.minimum[:, 2],
        b.maximum[:, 0], b.maximum[:, 1], b.maximum[:, 2]))})
    arrs.update(mats("b_", b.material))
    lights = scene.lights
    lp, lc = lights.point_position, lights.point_color
    sd = lights.sun_direction
    if counts["n_sun"]:
        sd = sd * torch.rsqrt(torch.sum(sd * sd, dim=-1, keepdim=True))
    for keys, a in ((PT_KEYS[:3], lp), (PT_KEYS[3:], lc), (SUN_KEYS[:3], sd),
                    (SUN_KEYS[3:], lights.sun_color)):
        arrs.update({k: _one(a[:, j]) for j, k in enumerate(keys)})
    sky = scene.sky
    arrs["z_sky"] = torch.cat([sky.horizon_color, sky.zenith_color, sky.ground_color,
                               sky.gradient_exponent.reshape(1)])
    arrs["z_tau"] = torch.as_tensor(tau, dtype=torch.float32, device=dev).reshape(1)
    arrs["z_tau_z"] = torch.as_tensor(tau_z, dtype=torch.float32, device=dev).reshape(1)
    packed = torch.cat([arrs[k].to(torch.float32) for k, _ in _PACK])
    return SoftTables(packed, counts)


def soft_gate_tables(scene: Scene, tau) -> torch.Tensor:
    """Per-chunk gate tables, ``[12, n_chunks]`` float32 in ``GATE_KEYS``
    order, without gradient; the counterpart of ``_soft_gate_arrays``.

    Each chunk's valid members get their radius inflated by the coverage
    sigmoid's underflow width, ``r_eff = sqrt(r^2 + 128 r tau)``: a unit ray
    line farther than ``r_eff`` from a centre has coverage exactly 0. Rows:
    the chunk's member centroid (xyz), its |.|^2, the squared bounding
    radius (member offset + r_eff, + ``GATE_PAD``; -1 for a chunk of pads
    only), the member spread for the behind-the-origin test, and the box of
    the inflated member balls (lo xyz, hi xyz, padded by ``GATE_PAD``).
    """
    counts = _counts(scene)
    with torch.no_grad():
        n, n_s_pad, n_c = counts["n_s"], counts["n_s_pad"], counts["n_chunks"]
        c = scene.spheres.center.detach().reshape(-1, 3)
        dev = c.device
        if n_s_pad > n:
            c = torch.cat([c, c.new_zeros((n_s_pad - n, 3))])
        r = _pad_to(scene.spheres.radius.detach(), n_s_pad, 0.0)
        tau = torch.as_tensor(tau, dtype=torch.float32, device=dev).detach()
        valid = (torch.arange(n_s_pad, device=dev) < n).reshape(n_c, SOFT_CHUNK)
        c3 = c.reshape(n_c, SOFT_CHUNK, 3)
        rr = r.reshape(n_c, SOFT_CHUNK)
        nv = valid.sum(dim=1)
        gc = (c3 * valid[..., None]).sum(dim=1) / torch.clamp_min(nv, 1)[..., None]
        off = torch.sqrt(torch.sum((c3 - gc[:, None, :]) ** 2, dim=-1))
        r_eff = torch.sqrt(rr * rr + GATE_SIG_MARGIN * rr * tau)
        gr = torch.amax(torch.where(valid, off + r_eff, 0.0), dim=1) + GATE_PAD
        gr2 = torch.where(nv > 0, gr * gr, -1.0)
        gsm = torch.amax(torch.where(valid, off, 0.0), dim=1) + GATE_PAD
        vm = valid[..., None]
        glo = torch.amin(torch.where(vm, c3 - r_eff[..., None], _BIG), dim=1) - GATE_PAD
        ghi = torch.amax(torch.where(vm, c3 + r_eff[..., None], -_BIG), dim=1) + GATE_PAD
        glo = torch.where((nv > 0)[:, None], glo, _BIG)
        ghi = torch.where((nv > 0)[:, None], ghi, -_BIG)
        rows = [gc[:, 0], gc[:, 1], gc[:, 2], torch.sum(gc * gc, dim=-1), gr2, gsm,
                glo[:, 0], glo[:, 1], glo[:, 2], ghi[:, 0], ghi[:, 1], ghi[:, 2]]
        return torch.stack(rows).to(torch.float32).contiguous()


def chunk_reachable(gates: torch.Tensor, gate: int, c: int, o: V3, d: V3, tau) -> torch.Tensor:
    """Whether each ray's line can reach chunk ``c`` (``gate``: the
    counts' ``GATE_AABB`` or ``GATE_SPHERE``): the kernels' per-lane gate.
    Where it is False, every member's coverage is exactly 0 in float32: the
    line stays outside the inflated chunk box or bounding sphere, or the
    chunk lies behind the origin past the front sigmoid's underflow width.
    Directions are unit (camera rays and mirror reflections)."""
    g = {k: gates[j, c] for j, k in enumerate(GATE_KEYS)}
    tau_eff = max_c(torch.as_tensor(tau, dtype=torch.float32, device=d.x.device), 1e-6)
    if gate == GATE_AABB:
        iv = (_srecip(d.x), _srecip(d.y), _srecip(d.z))
        b = [((g["gal" + x] - oc) * ivc, (g["gah" + x] - oc) * ivc)
             for x, oc, ivc in zip("xyz", o, iv)]
        tn = torch.maximum(torch.maximum(torch.minimum(*b[0]), torch.minimum(*b[1])),
                           torch.minimum(*b[2]))
        tf = torch.minimum(torch.minimum(torch.maximum(*b[0]), torch.maximum(*b[1])),
                           torch.maximum(*b[2]))
        return (tn <= tf) & (tf > -GATE_T_MARGIN * tau_eff) & (g["gr2"] >= 0.0)
    oo = o.x * o.x + o.y * o.y + o.z * o.z
    do = d.x * o.x + d.y * o.y + d.z * o.z
    s_g = d.x * g["gcx"] + d.y * g["gcy"] + d.z * g["gcz"]
    ogc = o.x * g["gcx"] + o.y * g["gcy"] + o.z * g["gcz"]
    tc = s_g - do  # closest approach on the line (unit d)
    dist2 = oo - 2.0 * ogc + g["gg"] + tc * (2.0 * (do - s_g) + tc)
    return (dist2 <= g["gr2"]) & (tc + g["gsm"] > -GATE_T_MARGIN * tau_eff)


# ---------------------------------------------------------------------------
# The level, plain PyTorch (the JAX package's _soft_t_ref, _soft_stream_sums
# and _soft_post, without gates)
# ---------------------------------------------------------------------------


def _lights_of(tbl: dict, counts: dict):
    """((point light 6-tuples), (sun 6-tuples)) of table entries."""
    pt = tuple(tuple(tbl[k][j] for k in PT_KEYS) for j in range(counts["n_pt"]))
    sun = tuple(tuple(tbl[k][j] for k in SUN_KEYS) for j in range(counts["n_sun"]))
    return pt, sun


def _chunk_size(counts: dict, c: int) -> int:
    """Real spheres of chunk ``c`` (the padding ones are skipped: the
    module docstring says where that differs from the JAX package)."""
    return max(min(SOFT_CHUNK, counts["n_s"] - c * SOFT_CHUNK), 0)


def _chunk(tbl: dict, c: int, nd: int, size: int = SOFT_CHUNK, keys=SPH_KEYS) -> dict:
    """The first ``size`` spheres of chunk ``c`` as ``[size, 1, ...]``
    columns that broadcast against ``nd``-dimensional ray planes."""
    sl = slice(c * SOFT_CHUNK, c * SOFT_CHUNK + size)
    return {k: tbl["s_" + k][sl].reshape(size, *([1] * nd)) for k in keys}


def _wb_params(tbl: dict, kind: str, i: int) -> dict:
    keys = (WALL_GEO_KEYS if kind == "w" else BOX_GEO_KEYS) + MAT_KEYS
    return {k: tbl[kind + "_" + k][i] for k in keys}


def _soft_t_ref(tbl: dict, counts: dict, o: V3, d: V3) -> torch.Tensor:
    """Each ray's anchor depth: the least t among the primitives with
    coverage above ``ALPHA_REF`` (``FAR`` if none), without gradient."""
    tau = tbl["z_tau"][0]
    t_ref = torch.full_like(d.x, FAR)
    for c in range(counts["n_chunks"]):
        size = _chunk_size(counts, c)
        if not size:
            continue
        alpha, t, _, _ = _sphere_alpha_t_scalar(_chunk(tbl, c, d.x.dim(), size), o, d, tau)
        t_ref = torch.minimum(t_ref, torch.where(alpha > ALPHA_REF, t, FAR).amin(dim=0))
    for kind, fn in (("w", _wall_alpha_t_scalar), ("b", _box_alpha_t_scalar)):
        for i in range(counts["n_" + kind]):
            alpha, t, _, _ = fn(_wb_params(tbl, kind, i), o, d, tau)
            t_ref = torch.minimum(t_ref, torch.where(alpha > ALPHA_REF, t, FAR))
    return t_ref


def _contrib_of(alpha, t, point: V3, n: V3, col: V3, met, t_ref, tau_z, is_last: bool):
    """One primitive's additive increments of the carry: its softmax weight
    ``e = alpha exp(-(t - t_ref)+ / tau_z)`` (at most 1: linear space needs
    no running max), ``e`` times each payload value, and ``log1p(-alpha)``."""
    e = alpha * torch.exp(-max_c(t - t_ref, 0.0) / tau_z)
    if is_last:
        pay = (col.x, col.y, col.z)
    else:
        pay = (col.x, col.y, col.z, col.x * met, col.y * met, col.z * met, met,
               point.x, point.y, point.z, n.x, n.y, n.z)
    lt = torch.log1p(-torch.minimum(alpha, alpha.new_full((), _ALPHA_MAX)))
    return [e] + [q * e for q in pay] + [lt]


def _sphere_contrib(lts, tau, tau_z, p: dict, o: V3, d: V3, t_ref, is_last: bool):
    alpha, t, point, n = _sphere_alpha_t_scalar(p, o, d, tau)
    col = _shade_point_scalar(point, n, V3(-d.x, -d.y, -d.z),
                              V3(p["colr"], p["colg"], p["colb"]),
                              p["amb"], p["kd"], p["ks"], p["exp"], lts[0], lts[1])
    return _contrib_of(alpha, t, point, n, col, p["met"], t_ref, tau_z, is_last)


def _wb_contrib(tbl: dict, counts: dict, o: V3, d: V3, t_ref, kind: str, i: int,
                is_last: bool):
    tau, tau_z = tbl["z_tau"][0], tbl["z_tau_z"][0]
    lts = _lights_of(tbl, counts)
    p = _wb_params(tbl, kind, i)
    fn = _wall_alpha_t_scalar if kind == "w" else _box_alpha_t_scalar
    alpha, t, point, n = fn(p, o, d, tau)
    col = _shade_point_scalar(point, n, V3(-d.x, -d.y, -d.z),
                              V3(p["colr"], p["colg"], p["colb"]),
                              p["amb"], p["kd"], p["ks"], p["exp"], lts[0], lts[1])
    return _contrib_of(alpha, t, point, n, col, p["met"], t_ref, tau_z, is_last)


def _n_carry(is_last: bool) -> int:
    """Carry planes: s, the payload sums (13, or 3 at the last level), and
    the log-transmittance."""
    return 5 if is_last else 15


def _soft_stream_sums(tbl: dict, counts: dict, o: V3, d: V3, t_ref, is_last: bool) -> list:
    """The composite carry, every primitive added in the kernels' order:
    the real spheres one by one, then the walls, then the boxes."""
    tau, tau_z = tbl["z_tau"][0], tbl["z_tau_z"][0]
    lts = _lights_of(tbl, counts)
    carry = [torch.zeros_like(d.x) for _ in range(_n_carry(is_last))]
    for c in range(counts["n_chunks"]):
        size = _chunk_size(counts, c)
        if not size:
            continue
        contrib = _sphere_contrib(lts, tau, tau_z, _chunk(tbl, c, d.x.dim(), size), o, d, t_ref,
                                  is_last)
        for u in range(size):
            carry = [a + v[u] for a, v in zip(carry, contrib)]
    for kind in ("w", "b"):
        for i in range(counts["n_" + kind]):
            contrib = _wb_contrib(tbl, counts, o, d, t_ref, kind, i, is_last)
            carry = [a + v for a, v in zip(carry, contrib)]
    return carry


def _soft_post(tbl: dict, carry, o: V3, d: V3, w, is_last: bool):
    """The composite's tail: ``(w lr, w lg, w lb, w_next, o_next xyz,
    d_next xyz)``. Normalises by the weight sum, blends over the sky with
    the union coverage and, before the last level, mirrors the ray about the
    expected surface (offset by ``max(1e-4, 6 tau)``, which clears the soft
    surface's own front sigmoid)."""
    tau, sky = tbl["z_tau"][0], tbl["z_sky"]
    s, log_transmit = carry[0], carry[-1]
    coverage = 1.0 - torch.exp(log_transmit)
    inv_s = 1.0 / max_c(s, 1e-12)  # 1/s^2 in the gradient overflows below ~1e-19
    z = d.z
    grad = torch.where(z > 0.0, torch.exp(sky[9] * torch.log(torch.where(z > 0.0, z, 1.0))), 0.0)
    sk = [torch.where(z < 0.0, sky[6 + k], sky[k] + (sky[3 + k] - sky[k]) * grad)
          for k in range(3)]
    if is_last:
        loc = [carry[1 + k] * inv_s * coverage + sk[k] * (1.0 - coverage) for k in range(3)]
        return (w * loc[0], w * loc[1], w * loc[2], w * 0.0, *o, *d)
    loc = [(carry[1 + k] - carry[4 + k]) * inv_s * coverage + sk[k] * (1.0 - coverage)
           for k in range(3)]
    m_hat = carry[7] * inv_s
    p_hat = V3(carry[8], carry[9], carry[10]) * inv_s
    n_hat = _normalized(V3(carry[11], carry[12], carry[13]) * inv_s, 1e-12)
    refl_o = p_hat + n_hat * max_c(6.0 * tau, REFLECT_EPS)
    refl_d = d - n_hat * (2.0 * d.dot(n_hat))
    w_next = w * (m_hat * coverage)
    return (w * loc[0], w * loc[1], w * loc[2], w_next, *refl_o, *refl_d)


def soft_level_reference(tables: SoftTables, o: V3, d: V3, w: torch.Tensor, acc: V3,
                         is_last: bool, emit_res: bool = False):
    """Plain version of ``soft_level``: ``(acc + w local, w_next, o_next V3,
    d_next V3, res)``; ``res`` is ``[1 + n_carry, ...]`` (``t_ref``, then the
    carry) with ``emit_res``, else ``None``. Every chunk for every lane (no
    gates). Differentiable by autograd in the table and the rays, except
    through ``t_ref``."""
    tbl = tables.arrays()
    counts = tables.counts
    with torch.no_grad():
        t_ref = _soft_t_ref({k: v.detach() for k, v in tbl.items()}, counts,
                            V3(*(c.detach() for c in o)), V3(*(c.detach() for c in d)))
    carry = _soft_stream_sums(tbl, counts, o, d, t_ref, is_last)
    outs = _soft_post(tbl, carry, o, d, w, is_last)
    acc = V3(acc.x + outs[0], acc.y + outs[1], acc.z + outs[2])
    res = torch.stack([t_ref, *carry]) if emit_res else None
    return acc, outs[3], V3(*outs[4:7]), V3(*outs[7:10]), res


def _add_sums(sums: torch.Tensor, layout: dict, key: str, grad, start: int = 0):
    """Add a per-lane cotangent ``[n, ...]`` of array ``key`` (items from
    ``start``) into the float64 ``sums``, summed over its lanes."""
    if grad is None:
        return
    off = layout[key][0] + start
    g = grad.double().reshape(grad.shape[0], -1).sum(dim=1)
    sums[off:off + g.shape[0]] += g


def soft_level_bwd_reference(tables: SoftTables, o: V3, d: V3, w: torch.Tensor,
                             res: torch.Tensor, ct_acc: V3, ct_next, is_last: bool,
                             sums: torch.Tensor) -> list:
    """The backward of one level, the plain version of ``soft_level_bwd``:
    the cotangents of the level's input rays and throughput, ``[ct_o xyz,
    ct_d xyz, ct_w]``, from the image cotangent ``ct_acc`` and ``ct_next``,
    those of the level's outputs (the next rays and throughput in the same
    order; ``None`` after the last level). The table's cotangent is added
    into ``sums`` (float64, the packed table's size).

    It has the kernel's structure: the vjp of ``_soft_post`` at the saved
    carry (``res[1:]``), then each primitive's contribution recomputed and
    differentiated on its own (a sphere chunk at a time) with the carry's
    cotangent, which is every contribution's, since the carry is their sum.
    ``t_ref`` (``res[0]``) is a constant. The table entries enter as
    per-lane copies, so their cotangents are summed over lanes in float64.
    """
    counts, layout = tables.counts, tables.layout
    base = tables.arrays(tables.packed.detach())
    shape, nd = w.shape, w.dim()
    ct7 = list(ct_next) if ct_next is not None else [torch.zeros_like(w) for _ in range(7)]
    t_ref, n_c = res[0], _n_carry(is_last)

    def lanes(keys, n_of=None):
        return {k: torch.zeros((n_of or layout[k][1], *shape), dtype=torch.float32,
                               device=w.device, requires_grad=True) for k in keys}

    with torch.enable_grad():
        rays = [c.detach().requires_grad_(True) for c in (*o, *d)]
        wv = w.detach().requires_grad_(True)
        carry = [c.detach().requires_grad_(True) for c in res[1:1 + n_c]]
        shared = lanes([k for k, _ in _PACK if not k.startswith("s_")])
        tbl = dict(base)
        tbl.update({k: base[k].reshape(-1, *([1] * nd)) + v for k, v in shared.items()})
        ov, dv = V3(*rays[:3]), V3(*rays[3:])
        outs = _soft_post(tbl, carry, ov, dv, wv, is_last)
        cts = (*ct_acc, ct7[6], *ct7[:6])
        g = torch.autograd.grad(outs, [*rays, wv, *carry, *shared.values()], cts,
                                allow_unused=True)
        ct_rays = [x if x is not None else torch.zeros_like(w) for x in g[:6]]
        ct_w = g[6] if g[6] is not None else torch.zeros_like(w)
        ct_carry = [x if x is not None else torch.zeros_like(w) for x in g[7:7 + n_c]]
        for k, x in zip(shared, g[7 + n_c:]):
            _add_sums(sums, layout, k, x)

        def take(contrib, extra: dict):
            grads = torch.autograd.grad(
                contrib, [*rays, *extra.values(), *shared.values()],
                [ct.expand_as(x) for ct, x in zip(ct_carry, contrib)], allow_unused=True)
            for j in range(6):
                if grads[j] is not None:
                    ct_rays[j] = ct_rays[j] + grads[j]
            return grads[6:]

        for kind in ("w", "b"):
            for i in range(counts["n_" + kind]):
                gi = take(_wb_contrib(tbl, counts, ov, dv, t_ref, kind, i, is_last), {})
                for k, x in zip(shared, gi):
                    _add_sums(sums, layout, k, x)
        lts = _lights_of(tbl, counts)
        tau, tau_z = tbl["z_tau"][0], tbl["z_tau_z"][0]
        for c in range(counts["n_chunks"]):
            size = _chunk_size(counts, c)
            if not size:
                continue
            sph = lanes(SPH_KEYS, size)
            p = {k: v + sph[k] for k, v in _chunk(base, c, nd, size).items()}
            gi = take(_sphere_contrib(lts, tau, tau_z, p, ov, dv, t_ref, is_last), sph)
            for k, x in zip(SPH_KEYS, gi[:len(SPH_KEYS)]):
                _add_sums(sums, layout, "s_" + k, x, c * SOFT_CHUNK)
            for k, x in zip(shared, gi[len(SPH_KEYS):]):
                _add_sums(sums, layout, k, x)
    return [*ct_rays, ct_w]


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

_SMEM_MAX = 232448  # bytes of shared memory a block can opt in to on the H100
_BLOCK = 256  # threads of a block of both kernels (csrc BLOCK)
_MASK_WORDS = 8  # lane-mask words the forward keeps for its second pass (csrc MASK_WORDS)
# Chunks of a tile of each kernel's sphere ring (csrc TILE_C of
# soft_level.cu and soft_level_bwd.cu).
_TILE_CHUNKS = 32
_TILE_CHUNKS_BWD = 32
# The backward's fixed-point sums of the spheres' cotangents
# (csrc/soft_level_bwd.cu): hi words in units of 2^-20, lo words in units
# of 2^-62, at most 2^27 lanes a launch.
_FX_HI, _FX_LO = 2.0 ** -20, 2.0 ** -62
_FX_MAX_LANES = 1 << 27
# Bounce levels of scenes of at least this many chunks launch their lanes
# in ``soft_lane_order``. At 1920x1080 on the H100 the sort (~0.9 ms) and
# the sorted last level beat the natural order from 256 spheres (32 chunks)
# up and lose at 64 and 128 (tools/soft_variants.py, PERF.md).
SOFT_ORDER_MIN_CHUNKS = 32


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def soft_launch_plan(counts: dict) -> dict:
    """The kernels' launch for a table of ``counts`` (``SoftTables.counts``):
    the chunks of a tile of each kernel's sphere ring of two tiles, its
    tiles, whether the forward's ring holds every tile at once
    (``resident``), and the dynamic shared memory of the forward (``smem``)
    and of the backward (``smem_bwd``) in bytes, which csrc/soft_level.cu
    and soft_level_bwd.cu compute the same way. Neither depends on the
    number of spheres."""
    tc, tcb = _TILE_CHUNKS, _TILE_CHUNKS_BWD
    n_small = _round4(sum(counts[s] for k, s in _PACK if not k.startswith("s_")))
    n_lt = 6 * (counts["n_pt"] + counts["n_sun"]) + 2
    sph = len(SPH_KEYS) * SOFT_CHUNK  # floats of a chunk's sphere columns
    bounds = _BLOCK // 32 * 16  # each warp's ray bounds
    n_tiles = -(-counts["n_chunks"] // tc)
    return {
        "tile_chunks": tc, "tile_chunks_bwd": tcb, "n_tiles": n_tiles,
        "n_tiles_bwd": -(-counts["n_chunks"] // tcb), "resident": n_tiles <= 2,
        "smem": 4 * (2 * (sph + len(GATE_KEYS)) * tc + n_small + _MASK_WORDS * _BLOCK + bounds),
        # the ring, the small table and each warp's row of its cotangent, the
        # lights' lane columns, the bounds; the spheres' fixed-point sums
        "smem_bwd": 4 * (2 * (sph + len(GATE_KEYS)) * tcb + (1 + _BLOCK // 32) * n_small
                         + n_lt * _BLOCK + bounds) + 16 * sph * tcb,
    }


def _check_soft(tables: SoftTables, gates: torch.Tensor, dev, name: str, bwd: bool = False):
    """What both kernels need on CUDA: the packed table and the gates
    contiguous on the rays' device, and the launch's shared memory (which
    grows with the walls, boxes and lights, never with the spheres) within
    a block's."""
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got {dev}")
    counts = tables.counts
    _check_planes((tables.packed,), (sum(counts[s] for _, s in _PACK),), dev, name)
    _check_planes((gates,), (len(GATE_KEYS), counts["n_chunks"]), dev, name)
    smem = soft_launch_plan(counts)["smem_bwd" if bwd else "smem"]
    if smem > _SMEM_MAX:
        raise ValueError(
            f"{name}: {counts['n_w']} walls, {counts['n_b']} boxes and "
            f"{counts['n_pt'] + counts['n_sun']} lights need {smem} bytes of shared memory, "
            f"more than the {_SMEM_MAX} a block can have"
        )


def _check_order(order, n: int, dev, name: str):
    if order is not None and (order.dtype != torch.int32 or order.shape != (n,)
                              or order.device != dev or not order.is_contiguous()):
        raise ValueError(f"{name} takes an order of {n} contiguous int32 on {dev}")


def _scene_args(tables: SoftTables, gates: torch.Tensor) -> tuple:
    """The launch's table arguments; the table 16-byte aligned (the ring
    copies 16 bytes at a time), copied if it is not."""
    c = tables.counts
    packed = tables.packed if tables.packed.data_ptr() % 16 == 0 else tables.packed.clone()
    return packed, (packed.data_ptr(), packed.numel(), gates.data_ptr(), c["n_s"],
                    c["n_s_pad"], c["n_w"], c["n_b"], c["n_pt"], c["n_sun"], c["gate"])


def _gathered(order, planes):
    """Each plane's lanes in ``order`` (flat)."""
    return [p.reshape(-1)[order] for p in planes]


def _scattered(order, flat, shape):
    """Planes of ``shape`` whose lane ``order[i]`` holds ``flat``'s lane i."""
    out = []
    for f in flat:
        p = torch.empty_like(f)
        p[order] = f
        out.append(p.reshape(shape))
    return out


def soft_level(tables: SoftTables, gates: torch.Tensor, o: V3, d: V3, w: torch.Tensor,
               acc: V3, is_last: bool, emit_res: bool = False, order=None):
    """One soft level: ``(acc + w local, w_next, o_next V3, d_next V3,
    res)`` as ``soft_level_reference`` returns them. On CPU tensors this is
    ``soft_level_reference``; on CUDA tensors it launches csrc/soft_level.cu
    on the current stream, or raises. The planes are contiguous float32 of
    one shape on one device. ``order`` (flat int32 lane indices, a
    permutation; ``soft_lane_order``) is the order the lanes run in: it
    changes no result (on the CPU the plain version runs on the lanes
    gathered in that order and its outputs are scattered back)."""
    dev, shape = w.device, w.shape
    _check_planes((*o, *d, w, *acc), shape, dev, "soft_level")
    _check_order(order, w.numel(), dev, "soft_level")
    if dev.type == "cpu":
        if order is None:
            return soft_level_reference(tables, o, d, w, acc, is_last, emit_res)
        g = _gathered(order, (*o, *d, w, *acc))
        out = soft_level_reference(tables, V3(*g[:3]), V3(*g[3:6]), g[6], V3(*g[7:]), is_last,
                                   emit_res)
        flat = [*out[0], out[1], *out[2], *out[3]] + (list(out[4]) if emit_res else [])
        p = _scattered(order, flat, shape)
        res = torch.stack(p[10:]) if emit_res else None
        return V3(*p[:3]), p[3], V3(*p[4:7]), V3(*p[7:10]), res
    _check_soft(tables, gates, dev, "soft_level")
    return _soft_level_cuda(tables, gates, o, d, w, acc, is_last, emit_res, order)


def _soft_level_cuda(tables, gates, o, d, w, acc, is_last, emit_res, order):
    dev, shape = w.device, w.shape
    n_out = 10 + (1 + _n_carry(is_last) if emit_res else 0)
    out = torch.empty((n_out, *shape), dtype=torch.float32, device=dev)
    if w.numel():
        lib = _build.load("soft_level", _SIGNATURES["soft_level"])
        _packed, scene = _scene_args(tables, gates)
        err = lib.soft_level_launch(
            *scene, *_ptrs((*o, *d, w, *acc, order)), out.data_ptr(),
            w.numel(), int(is_last), int(emit_res), _stream(dev),
        )
        _raise_on(err, lib, "soft_level")
        soft_level.launches += 1
    return (V3(out[0], out[1], out[2]), out[3], V3(out[4], out[5], out[6]),
            V3(out[7], out[8], out[9]), out[10:] if emit_res else None)


soft_level.launches = 0


def soft_level_bwd(tables: SoftTables, gates: torch.Tensor, o: V3, d: V3, w: torch.Tensor,
                   res: torch.Tensor, ct_acc: V3, ct_next, is_last: bool,
                   sums: torch.Tensor, order=None) -> list:
    """The backward of one level, ``[ct_o xyz, ct_d xyz, ct_w]``, as
    ``soft_level_bwd_reference`` computes it, the table's cotangent added
    into the float64 ``sums``. On CPU tensors this is
    ``soft_level_bwd_reference``; on CUDA tensors it launches
    csrc/soft_level_bwd.cu on the current stream, or raises. ``res`` is the
    level's ``soft_level(..., emit_res=True)`` residual, ``order`` the
    order its lanes ran in (as ``soft_level`` takes it)."""
    dev, shape = w.device, w.shape
    name = "soft_level_bwd"
    _check_planes((*o, *d, w, *ct_acc), shape, dev, name)
    _check_planes((res,), (1 + _n_carry(is_last), *shape), dev, name)
    if ct_next is not None:
        _check_planes(tuple(ct_next), shape, dev, name)
    _check_planes((sums,), tuple(tables.packed.shape), dev, name, torch.float64)
    _check_order(order, w.numel(), dev, name)
    if dev.type == "cpu":
        if order is None:
            return soft_level_bwd_reference(tables, o, d, w, res, ct_acc, ct_next, is_last, sums)
        g = _gathered(order, (*o, *d, w, *ct_acc, *(ct_next if ct_next is not None else ())))
        r = [x.reshape(-1)[order] for x in res]
        cts = soft_level_bwd_reference(
            tables, V3(*g[:3]), V3(*g[3:6]), g[6], torch.stack(r), V3(*g[7:10]),
            g[10:] if ct_next is not None else None, is_last, sums)
        return _scattered(order, cts, shape)
    _check_soft(tables, gates, dev, name, bwd=True)
    if w.numel() > _FX_MAX_LANES:
        raise ValueError(f"{name} takes at most {_FX_MAX_LANES} lanes a launch, got {w.numel()}")
    return _soft_level_bwd_cuda(tables, gates, o, d, w, res, ct_acc, ct_next, is_last, sums,
                                order)


def _soft_level_bwd_cuda(tables, gates, o, d, w, res, ct_acc, ct_next, is_last, sums, order):
    dev, shape, name = w.device, w.shape, "soft_level_bwd"
    cts = torch.empty((7, *shape), dtype=torch.float32, device=dev)
    if w.numel():
        lib = _build.load(name, _SIGNATURES[name])
        _packed, scene = _scene_args(tables, gates)
        wall = len(SPH_KEYS) * tables.counts["n_s_pad"]
        fx = torch.zeros((2, sums.numel()), dtype=torch.int64, device=dev)
        # A row a block: at most as many blocks as fit on the card at once.
        n_rows = torch.cuda.get_device_properties(dev).multi_processor_count * (2048 // _BLOCK)
        rows = torch.zeros((n_rows, sums.numel() - wall), dtype=torch.float64, device=dev)
        err = lib.soft_level_bwd_launch(
            *scene, *_ptrs((*o, *d, w)), res.data_ptr(),
            *_ptrs(ct_acc), *_ptrs(ct_next if ct_next is not None else (None,) * 7),
            _ptrs((order,))[0], cts.data_ptr(), sums.data_ptr(), fx.data_ptr(),
            rows.data_ptr(), n_rows, w.numel(), int(is_last), _stream(dev),
        )
        _raise_on(err, lib, name)
        soft_level_bwd.launches += 1
        # Sums in an order that does not vary between runs: the spheres'
        # fixed-point table (integer sums) in float64, the blocks' rows of
        # the small table in row order.
        sums += fx[0].double() * _FX_HI + fx[1].double() * _FX_LO
        sums[wall:] += rows.sum(0)
    return list(cts.unbind(0))


soft_level_bwd.launches = 0


_SPREAD6: dict = {}


def _spread6(dev) -> torch.Tensor:
    """[1024] int64: each 10-bit value with its bits 6 apart (bit b at 6 b)."""
    lut = _SPREAD6.get(dev)
    if lut is None:
        v = torch.arange(1024, dtype=torch.int64)
        lut = torch.zeros_like(v)
        for b in range(10):
            lut |= ((v >> b) & 1) << (6 * b)
        lut = _SPREAD6[dev] = lut.to(dev)
    return lut


def soft_lane_order(o: V3, d: V3) -> torch.Tensor:
    """A lane order (flat int32 indices) that puts rays with close origins
    and directions together: the rays sorted by the 60-bit Morton code of
    their origin (10 bits an axis over the rays' box) and direction (10 bits
    an axis over [-1, 1]), the six coordinates' bits interleaved, so a warp
    and a block hold rays that reach the same sphere chunks."""
    lut = _spread6(d.x.device)
    key = None
    for j, (c, lo, hi) in enumerate(
            [(c.reshape(-1), c.amin(), c.amax()) for c in o]
            + [(c.reshape(-1), -1.0, 1.0) for c in d]):
        span = torch.clamp_min(torch.as_tensor(hi - lo, dtype=torch.float32), 1e-12)
        q = torch.nan_to_num((c - lo) / span * 1023.0).clamp(0, 1023).to(torch.int64)
        code = lut[q] << j
        key = code if key is None else key | code
    return torch.argsort(key, stable=True).to(torch.int32)


def _orders_level(counts: dict, k: int) -> bool:
    """Whether ``soft_levels`` launches level ``k`` in ``soft_lane_order``."""
    return k > 0 and counts["n_chunks"] >= SOFT_ORDER_MIN_CHUNKS


def soft_levels(tables: SoftTables, gates: torch.Tensor, o: V3, d: V3, depth: int,
                emit_res: bool = False):
    """Every soft level of a ray tile, level 0's throughput 1: ``(rgb V3,
    levels)``; with ``emit_res``, ``levels`` holds each level's ``(o, d, w,
    res, order)`` for the backward (``order`` None where the level ran in
    the natural order), else it is empty. The counterpart of the JAX
    package's ``_soft_levels_impl`` (its ``_prep_rays`` padding is not
    needed: the kernel takes any number of lanes)."""
    w = torch.ones_like(d.x)
    acc = V3(*(torch.zeros_like(w) for _ in range(3)))
    levels = []
    for k in range(depth + 1):
        order = soft_lane_order(o, d) if _orders_level(tables.counts, k) else None
        acc_n, w_n, o_n, d_n, res = soft_level(tables, gates, o, d, w, acc, k == depth,
                                               emit_res, order)
        if emit_res:
            levels.append((o, d, w, res, order))
        acc, w, o, d = acc_n, w_n, o_n, d_n
    return acc, levels


def soft_levels_bwd(tables: SoftTables, gates: torch.Tensor, levels: list, ct_acc: V3):
    """The backward of ``soft_levels(..., emit_res=True)``: ``(ct_o V3, ct_d
    V3, ct_packed)``. ``soft_level_bwd`` for the levels in reverse, each in
    its forward's lane order, each level's ray and throughput cotangents
    feeding the level before; the table's cotangent summed in float64 over
    all levels. The counterpart of ``_soft_levels_bwd_impl``."""
    sums = torch.zeros(tables.packed.shape, dtype=torch.float64, device=tables.packed.device)
    ct = None
    depth = len(levels) - 1
    for k in reversed(range(depth + 1)):
        o, d, w, res, order = levels[k]
        ct = soft_level_bwd(tables, gates, o, d, w, res, ct_acc, ct, k == depth, sums, order)
    return V3(*ct[:3]), V3(*ct[3:6]), sums.float()


class _SoftTrace(torch.autograd.Function):
    """``soft_levels(emit_res=True)`` with ``soft_levels_bwd`` as its
    backward: the counterpart of the JAX package's ``soft_trace_pallas``
    custom VJP. ``packed`` (``soft_tables``' vector, built with autograd)
    carries the table's cotangent back to the scene's leaves and the
    temperatures; the gates take none."""

    @staticmethod
    def forward(ctx, counts, gates, depth, packed, ox, oy, oz, dx, dy, dz):
        tables = SoftTables(packed.detach(), counts)
        acc, levels = soft_levels(tables, gates, V3(ox, oy, oz), V3(dx, dy, dz), depth,
                                  emit_res=True)
        ctx.counts = counts
        ctx.ordered = [lv[4] is not None for lv in levels]
        ctx.save_for_backward(packed, gates, *(t for lv in levels for t in (
            *lv[0], *lv[1], lv[2], lv[3], lv[4] if lv[4] is not None else lv[3].new_empty(0))))
        return tuple(acc)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct_r, ct_g, ct_b):
        packed, gates, *flat = ctx.saved_tensors
        levels = [(V3(*flat[i:i + 3]), V3(*flat[i + 3:i + 6]), flat[i + 6], flat[i + 7],
                   flat[i + 8] if ordered else None)
                  for i, ordered in zip(range(0, len(flat), 9), ctx.ordered)]
        tables = SoftTables(packed.detach(), ctx.counts)
        ct = V3(*(c.contiguous() for c in (ct_r, ct_g, ct_b)))
        ct_o, ct_d, ct_packed = soft_levels_bwd(tables, gates, levels, ct)
        return None, None, None, ct_packed, *ct_o, *ct_d


# C signatures of the exported functions of csrc/soft_level.cu and
# csrc/soft_level_bwd.cu.
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SCENE_ARGTYPES = [_P, _I, _P] + [_I] * 7
_SIGNATURES = {
    "soft_level": {
        "soft_level_launch": (_I, _SCENE_ARGTYPES + [_P] * 12 + [_LL, _I, _I, _P]),
        "soft_level_smem_bytes": (_LL, [_I]),
        "soft_level_error_string": (ctypes.c_char_p, [_I]),
    },
    "soft_level_bwd": {
        "soft_level_bwd_launch": (_I, _SCENE_ARGTYPES + [_P] * 23 + [_I, _LL, _I, _P]),
        "soft_level_bwd_smem_bytes": (_LL, [_I, _I]),
        "soft_level_bwd_error_string": (ctypes.c_char_p, [_I]),
    },
}
