"""The plain hard renderer: closest hit over every sphere and wall, Blinn-
Phong shading, the sky, mirror bounces and the Reinhard tone map.

The closest hit is a brute-force search over all primitives (no chunks, no
gates, no shortlists): a sphere's near root ``-b - sqrt(b^2 - c)`` in the
``o - centre`` form, a wall's plane distance inside its rectangle, the
least positive distance winning and ties going to the lower index (spheres
first). The selection carries no gradient; the hit point, normal, shading
and bounce are differentiable in the sphere centres and colours at that
selection, which is the gradient the program's hard fit takes. Frames are
computed in blocks of rows, and each level searches only the lanes whose
throughput is still above 0.
"""

from __future__ import annotations

import torch

from benchmark.reference.common import (
    MISS_T,
    REFLECT_EPS,
    blinn_phong,
    max_c,
    camera_rays,
    dot,
    row_blocks,
    sky,
    tonemap,
    unit_suns,
    wall_basis,
)

# Lane x sphere elements of one block of the search: bounds its temporaries.
_SEARCH_ELEMS = 1 << 25
# Rays of one block of rows.
_BLOCK_LANES = 1 << 19


def _sphere_candidates(o, d, c, r2):
    """``[B, S]`` near-root distances (``MISS_T`` where there is none);
    ``o`` is ``[3]`` (one origin) or ``[B, 3]``."""
    if o.dim() == 1:
        ocx, ocy, ocz = ((o[k] - c[:, k])[None, :] for k in range(3))
    else:
        ocx, ocy, ocz = (o[:, k:k + 1] - c[None, :, k] for k in range(3))
    b = d[:, 0:1] * ocx + d[:, 1:2] * ocy + d[:, 2:3] * ocz
    cc = ocx * ocx + ocy * ocy + ocz * ocz - r2
    t = -b - torch.sqrt(b * b - cc)  # NaN where the line misses: fails both compares
    return torch.where((t > 0.0) & (t < MISS_T), t, MISS_T)


def _wall_candidates(o, d, scene: dict, basis):
    """``[B, M]`` distances to each wall's rectangle (``MISS_T`` off it)."""
    n, p = scene["wall_normal"], scene["wall_position"]
    right, up = basis
    ob = o.expand_as(d)
    denom = torch.sum(d[:, None, :] * n[None], dim=-1)
    ok = torch.abs(denom) > 1e-12
    num = torch.sum(p * n, dim=-1)[None, :] - torch.sum(ob[:, None, :] * n[None], dim=-1)
    t = num / torch.where(ok, denom, 1.0)
    rel = ob[:, None, :] + d[:, None, :] * t[..., None] - p[None]
    u = torch.sum(rel * right[None], dim=-1)
    v = torch.sum(rel * up[None], dim=-1)
    valid = (ok & (t > 0.0) & (t < MISS_T) & (u >= 0.0) & (u <= scene["wall_length"])
             & (v >= 0.0) & (v <= scene["wall_width"]))
    return torch.where(valid, t, MISS_T)


def _first_min(cand: torch.Tensor, base: int):
    """(least distance, lowest index holding it) along dim 1."""
    bt = cand.amin(dim=1)
    pos = torch.arange(cand.shape[1], device=cand.device)
    bi = torch.where(cand == bt[:, None], pos, cand.shape[1]).amin(dim=1) + base
    return bt, bi


@torch.no_grad()
def closest_hit(scene: dict, basis, o: torch.Tensor, d: torch.Tensor):
    """``(t, index)`` of each ray's closest hit, ``(MISS_T, -1)`` on a
    miss; indices count the spheres, then the walls."""
    n_s, n_m = scene["sph_radius"].shape[0], scene["wall_length"].shape[0]
    bt = torch.full(d.shape[:1], MISS_T, dtype=d.dtype, device=d.device)
    bi = torch.full(d.shape[:1], -1, dtype=torch.long, device=d.device)
    if n_s:
        c = scene["sph_center"].detach()
        r2 = (scene["sph_radius"] * scene["sph_radius"]).detach()[None, :]
        step = max(1, _SEARCH_ELEMS // n_s)
        for a in range(0, d.shape[0], step):
            sl = slice(a, a + step)
            oo = o if o.dim() == 1 else o[sl]
            t, i = _first_min(_sphere_candidates(oo, d[sl], c, r2), 0)
            bt[sl], bi[sl] = t, i
    if n_m:
        t, i = _first_min(_wall_candidates(o, d, scene, basis), n_s)
        win = t < bt  # a tie goes to the sphere, whose index is lower
        bt, bi = torch.where(win, t, bt), torch.where(win, i, bi)
    return bt, torch.where(bt < MISS_T, bi, -1)


def _level(scene: dict, suns, o, d, w, t_sel, idx, is_last: bool):
    """One level's shading, accumulation and bounce at a fixed selection:
    ``(increment, w_next, o_next, d_next)``; differentiable in the scene's
    sphere leaves and the rays."""
    n_s = scene["sph_radius"].shape[0]
    n_m = scene["wall_length"].shape[0]
    hit = idx >= 0
    is_s = hit & (idx < n_s)
    is_w = hit & (idx >= n_s)
    si = idx.clamp(0, max(n_s - 1, 0))
    wi = (idx - n_s).clamp(0, max(n_m - 1, 0))
    o = o.expand_as(d)
    c, r = scene["sph_center"][si], scene["sph_radius"][si]
    oc = o - c
    bq = 2.0 * dot(d, oc)
    det = bq * bq - 4.0 * (dot(oc, oc) - r * r)
    pos = det > 0.0
    tt = torch.where(is_s & pos, 0.5 * (-bq - torch.sqrt(torch.where(pos, det, 1.0))), t_sel)
    wn, wp = scene["wall_normal"][wi], scene["wall_position"][wi]
    denom = dot(d, wn)
    ok = torch.abs(denom) > 1e-12
    tt = torch.where(is_w & ok, dot(wp - o, wn) / torch.where(ok, denom, 1.0), tt)
    point = o + d * torch.where(hit, tt, 1.0)[:, None]
    normal = torch.where(is_w[:, None], wn, (point - c) / max_c(r, 1e-12)[:, None])
    up = torch.zeros_like(normal)
    up[:, 2] = 1.0
    normal = torch.where(hit[:, None], normal, up)

    def mat(key, width=None):
        s, m = scene["sph_" + key][si], scene["wall_" + key][wi]
        cond = is_s if width is None else is_s[:, None]
        v = torch.where(cond, s, m)
        return torch.where(hit if width is None else hit[:, None], v, 0.0)

    met = mat("metallic")
    local = blinn_phong(point, normal, -d, mat("color", 3), mat("ambient"), mat("diffuse"),
                        mat("specular"), mat("exponent"), scene, suns)
    colour = local if is_last else local * (1.0 - met)[:, None]
    inc = torch.where((hit & (w > 0.0))[:, None], colour, sky(d, scene)) * w[:, None]
    w_next = w * torch.where(hit, met, 0.0)
    o_next = torch.where(hit[:, None], point + normal * REFLECT_EPS, o)
    d_next = torch.where(hit[:, None], d - normal * (2.0 * dot(d, normal))[:, None], d)
    return inc, w_next, o_next, d_next


def trace_rows(scene: dict, cam: dict, width: int, height: int, row0: int, rows: int,
               depth: int, stats: list | None = None) -> torch.Tensor:
    """Radiance of rows ``[row0, row0 + rows)``, ``[rows, W, 3]``. With
    ``stats`` (a list of one dict per level), each level's lane counts are
    added into it (``_count``)."""
    check_scene(scene)
    basis = wall_basis(scene["wall_normal"].detach())
    suns = unit_suns(scene)
    o0, d = camera_rays(cam, width, height, row0, rows)
    o = o0
    w = torch.ones(d.shape[0], dtype=d.dtype, device=d.device)
    acc = torch.zeros_like(d)
    for k in range(depth + 1):
        with torch.no_grad():
            if k == 0:
                t_sel, idx = closest_hit(scene, basis, o0.detach(), d.detach())
            else:
                lanes = torch.nonzero(w.detach() > 0.0).squeeze(1)
                t_sel = torch.full_like(w.detach(), MISS_T)
                idx = torch.full(w.shape, -1, dtype=torch.long, device=w.device)
                if lanes.numel():
                    t_a, i_a = closest_hit(scene, basis, o.detach()[lanes], d.detach()[lanes])
                    t_sel[lanes], idx[lanes] = t_a, i_a
            if stats is not None:
                _count(stats[k], scene, o.detach().expand_as(d), d.detach(), w.detach(), idx)
        inc, w, o, d = _level(scene, suns, o, d, w, t_sel, idx, k == depth)
        acc = acc + inc
    return acc.reshape(rows, width, 3)


def check_scene(scene: dict) -> None:
    """The references render spheres and walls; a scene with boxes, or
    without a sphere or a wall, is outside them."""
    if scene["box_min"].shape[0] or not scene["sph_radius"].shape[0] \
            or not scene["wall_length"].shape[0]:
        raise ValueError("the reference renders scenes of spheres and walls only")


def _count(c: dict, scene: dict, o, d, w, idx):
    """Per level: alive lanes, their hits on spheres and walls and misses,
    and the alive lanes whose line meets the box of all spheres (``used``)."""
    n_s = scene["sph_radius"].shape[0]
    alive = w > 0.0
    c["alive"] = c.get("alive", 0) + int(alive.sum())
    c["sphere"] = c.get("sphere", 0) + int((alive & (idx >= 0) & (idx < n_s)).sum())
    c["wall"] = c.get("wall", 0) + int((alive & (idx >= n_s)).sum())
    c["miss"] = c.get("miss", 0) + int((alive & (idx < 0)).sum())
    used = alive
    if n_s:
        cen, r = scene["sph_center"].detach(), scene["sph_radius"].detach()[:, None]
        lo, hi = (cen - r).amin(dim=0), (cen + r).amax(dim=0)
        inv = 1.0 / torch.where(torch.abs(d) > 1e-12, d, 1e-12)
        ta, tb = (lo - o) * inv, (hi - o) * inv
        tn = torch.minimum(ta, tb).amax(dim=1).clamp_min(0.0)
        tf = torch.maximum(ta, tb).amin(dim=1)
        used = alive & (tf >= tn)
    c["used"] = c.get("used", 0) + int(used.sum())
    c["lanes"] = c.get("lanes", 0) + int(w.numel())


def render(scene: dict, cam: dict, width: int, height: int, depth: int, *,
           tone: bool = True, lanes: int = _BLOCK_LANES, stats: list | None = None):
    """The frame, ``[H, W, 3]``, in blocks of rows, without gradient."""
    with torch.no_grad():
        out = [trace_rows(scene, cam, width, height, r0, n, depth, stats)
               for r0, n in row_blocks(height, width, lanes)]
        img = torch.cat(out, dim=0)
        return tonemap(img) if tone else img


def loss_and_grads(scene: dict, params: dict, cam: dict, width: int, height: int, depth: int,
                   target: torch.Tensor, *, tone: bool = True, lanes: int = _BLOCK_LANES,
                   stats: list | None = None, rows: int | None = None):
    """The mean squared error of the frame against ``target`` and its
    gradient in ``params`` (leaves named ``center`` and ``color``, written
    into the scene's spheres), one block of rows at a time. ``rows`` takes
    the mean over the frame's first rows only (a fault the tests plant)."""
    for p in params.values():
        p.grad = None
    full = dict(scene, sph_center=params["center"], sph_color=params["color"])
    rows = height if rows is None else rows
    scale = 1.0 / (rows * width * 3)
    total = torch.zeros((), dtype=torch.float64, device=target.device)
    for r0, n in row_blocks(rows, width, lanes):
        img = trace_rows(full, cam, width, height, r0, n, depth, stats)
        if tone:
            img = tonemap(img)
        term = torch.sum((img - target[r0:r0 + n]) ** 2) * scale
        term.backward()
        total += term.detach().to(torch.float64)
    return total, {k: p.grad for k, p in params.items()}
