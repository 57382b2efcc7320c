"""The plain soft renderer: relaxed coverage and occlusion, with autograd.

Each primitive's hit test becomes a coverage ``alpha``: a sphere's is
``sigmoid(disc / (2 r tau)) * sigmoid(t / tau)``, a wall's the product of
sigmoids of its rectangle bounds and of ``t / tau``. Each ray anchors at
``t_ref``, the least distance among the primitives of coverage above 0.3
(1e4 if none), found without gradient. The primitives composite with the
weights ``e = alpha exp(-max(t - t_ref, 0) / tau_z)``: the shaded colours,
normalised by the weight sum, over the sky with the union coverage ``1 -
prod(1 - alpha)``. Before the last level each ray reflects about the
expected surface (the weighted hit point and normal), offset by ``max(6
tau, 1e-4)``, with throughput times the weighted metallic and the coverage.

A sphere whose coverage of a ray is exactly 0 in the working precision
adds exactly nothing to that ray, value and gradient alike. So each block
of rays first finds, without gradient, the spheres that cover each ray at
all, and composites only those, gathered per ray; that is the same sum in
another order. Frames go in blocks of rows: each block's term of the loss
is differentiated on its own, and the gradients add up in the leaves.
"""

from __future__ import annotations

import torch

from benchmark.reference.common import (
    REFLECT_EPS,
    blinn_phong,
    camera_rays,
    dot,
    max_c,
    min_c,
    normalize_eps,
    row_blocks,
    sky,
    tonemap,
    unit_suns,
    wall_basis,
)

FAR = 1e4  # the anchor of a ray that nothing covers above ALPHA_REF
ALPHA_REF = 0.3
_SEARCH_ELEMS = 1 << 25  # lane x sphere elements of one block of the search
_BLOCK_LANES = 1 << 18  # rays of one block of rows


def _alpha_max(dtype) -> float:
    """The largest coverage ``log1p(-alpha)`` is given: float32(1 - 1e-7),
    or the largest value below 1 of a coarser type."""
    one = torch.tensor(1.0 - 1e-7, dtype=dtype)
    return float(one) if float(one) < 1.0 else 1.0 - torch.finfo(dtype).eps / 2


def _sphere_terms(o, d, c, r, tau):
    """(coverage, distance) of spheres ``c``, ``r`` (broadcast against
    the rays ``o``, ``d``; the last dim of ``c`` is xyz). Past the
    silhouette the distance continues as ``-b``."""
    oc = o - c
    b = dot(d, oc)
    disc = b * b - (dot(oc, oc) - r * r)
    pos = disc > 0.0
    t = -b - torch.where(pos, torch.sqrt(torch.where(pos, disc, 1.0)), 0.0)
    alpha = torch.sigmoid(disc / (tau * 2.0 * max_c(r, 1e-6)))
    return alpha * torch.sigmoid(t / max(tau, 1e-6)), t


def _wall_terms(o, d, scene: dict, basis, tau):
    """(coverage, distance, point) of every wall, ``[B, M]`` (point
    ``[B, M, 3]``)."""
    n, p = scene["wall_normal"], scene["wall_position"]
    right, up = basis
    denom = torch.sum(d[:, None, :] * n[None], dim=-1)
    ok = torch.abs(denom) > 1e-6
    o = o.expand_as(d)
    t = (torch.sum(p * n, dim=-1)[None] - torch.sum(o[:, None, :] * n[None], dim=-1)) \
        / torch.where(ok, denom, 1.0)
    point = o[:, None, :] + d[:, None, :] * t[..., None]
    rel = point - p[None]
    u = torch.sum(rel * right[None], dim=-1)
    v = torch.sum(rel * up[None], dim=-1)
    s = torch.sigmoid
    alpha = (s(u / tau) * s((scene["wall_length"] - u) / tau) * s(v / tau)
             * s((scene["wall_width"] - v) / tau) * s(t / max(tau, 1e-6)) * ok.to(t.dtype))
    return alpha, t, point


@torch.no_grad()
def _covering(scene: dict, o, d, tau, basis):
    """``(index [B, K], valid [B, K], t_ref [B], pairs)``: the spheres that
    cover each ray at all (padded with index 0, not valid), each ray's
    anchor, and the number of covering (ray, sphere) pairs."""
    c, r = scene["sph_center"].detach(), scene["sph_radius"].detach()
    n_s, b = r.shape[0], d.shape[0]
    step = max(1, _SEARCH_ELEMS // n_s)
    t_ref = torch.full((b,), FAR, dtype=d.dtype, device=d.device)
    masks = []
    for a in range(0, b, step):
        sl = slice(a, a + step)
        oo = o if o.dim() == 1 else o[sl]
        alpha, t = _sphere_terms(oo[..., None, :], d[sl][:, None, :], c[None], r[None], tau)
        t_ref[sl] = torch.where(alpha > ALPHA_REF, t, FAR).amin(dim=1)
        masks.append(alpha > 0.0)
    mask = torch.cat(masks)
    wa, wt, _ = _wall_terms(o, d, scene, basis, tau)
    t_ref = torch.minimum(t_ref, torch.where(wa > ALPHA_REF, wt, FAR).amin(dim=1))
    k = int(mask.sum(dim=1).max()) if b else 0
    if k == 0:
        z = torch.zeros((b, 0), dtype=torch.long, device=d.device)
        return z, z.bool(), t_ref, 0
    valid, index = torch.topk(mask.to(torch.int8), k, dim=1)
    return index, valid.bool(), t_ref, int(mask.sum())


def _level(scene: dict, suns, o, d, w, tau, tau_z, is_last: bool, stats: dict | None):
    """One soft level on a block of rays: ``(increment, w_next, o_next,
    d_next)``, differentiable in the scene's sphere leaves and the rays."""
    basis = wall_basis(scene["wall_normal"].detach())
    index, valid, t_ref, pairs = _covering(scene, o.detach(), d.detach(), tau, basis)
    if stats is not None:
        stats["pairs"] = stats.get("pairs", 0) + pairs
        stats["lanes"] = stats.get("lanes", 0) + d.shape[0]
    amax = _alpha_max(d.dtype)
    view = -d
    ob = o.expand_as(d)

    def terms(alpha, t, point, normal, colour, met):
        """A primitive's weight ``e``, its payloads and ``log(1 - alpha)``."""
        e = alpha * torch.exp(-max_c(t - t_ref[:, None], 0.0) / tau_z)
        lt = torch.log1p(-min_c(alpha, amax))
        return e, colour, met, point, normal, lt

    # The covering spheres, [B, K].
    def g(key):
        return scene["sph_" + key][index]

    c, r = g("center"), g("radius")
    alpha, t = _sphere_terms(ob[:, None, :], d[:, None, :], c, r, tau)
    point = ob[:, None, :] + d[:, None, :] * t[..., None]
    normal = normalize_eps(point - c, 1e-12)
    colour = blinn_phong(point, normal, view[:, None, :].expand_as(point), g("color"),
                         g("ambient"), g("diffuse"), g("specular"), g("exponent"), scene, suns)
    sph = terms(alpha, t, point, normal, colour, g("metallic"))
    # Every wall, [B, M].
    wa, wt, wpt = _wall_terms(ob, d, scene, basis, tau)
    m = wa.shape[1]
    wn = scene["wall_normal"][None].expand(d.shape[0], m, 3)

    def wm(key):
        return scene["wall_" + key][None].expand(d.shape[0], m, *scene["wall_" + key].shape[1:])

    wcol = blinn_phong(wpt, wn, view[:, None, :].expand_as(wpt), wm("color"), wm("ambient"),
                       wm("diffuse"), wm("specular"), wm("exponent"), scene, suns)
    wal = terms(wa, wt, wpt, wn, wcol, wm("metallic"))

    def total(fn):
        """The sum over the covering spheres and every wall of ``fn``."""
        zero = torch.zeros((), dtype=d.dtype, device=d.device)
        s = torch.where(valid.view(*valid.shape, *([1] * (fn(sph).dim() - 2))), fn(sph), zero)
        return s.sum(dim=1) + fn(wal).sum(dim=1)

    s_w = total(lambda q: q[0])
    log_t = total(lambda q: q[5])
    cov = 1.0 - torch.exp(log_t)
    inv_s = 1.0 / max_c(s_w, 1e-12)
    sk = sky(d, scene)
    col_sum = total(lambda q: q[0][..., None] * q[1])
    if is_last:
        loc = col_sum * (inv_s * cov)[:, None] + sk * (1.0 - cov)[:, None]
        return w[:, None] * loc, w * 0.0, ob, d
    colm_sum = total(lambda q: (q[0] * q[2])[..., None] * q[1])
    loc = (col_sum - colm_sum) * (inv_s * cov)[:, None] + sk * (1.0 - cov)[:, None]
    m_hat = total(lambda q: q[0] * q[2]) * inv_s
    p_hat = total(lambda q: q[0][..., None] * q[3]) * inv_s[:, None]
    n_hat = normalize_eps(total(lambda q: q[0][..., None] * q[4]) * inv_s[:, None], 1e-12)
    o_next = p_hat + n_hat * max(6.0 * tau, REFLECT_EPS)
    d_next = d - n_hat * (2.0 * dot(d, n_hat))[:, None]
    return w[:, None] * loc, w * (m_hat * cov), o_next, d_next


def trace_rows(scene: dict, cam: dict, width: int, height: int, row0: int, rows: int,
               depth: int, tau: float, tau_z: float, stats: list | None = None):
    """Softly composited radiance of rows ``[row0, row0 + rows)``,
    ``[rows, W, 3]``, after ``depth`` expected-surface reflections."""
    suns = unit_suns(scene)
    o, d = camera_rays(cam, width, height, row0, rows)
    w = torch.ones(d.shape[0], dtype=d.dtype, device=d.device)
    acc = torch.zeros_like(d)
    for k in range(depth + 1):
        inc, w, o, d = _level(scene, suns, o, d, w, tau, tau_z, k == depth,
                              None if stats is None else stats[k])
        acc = acc + inc
    return acc.reshape(rows, width, 3)


def render(scene: dict, cam: dict, width: int, height: int, depth: int, tau: float,
           tau_z: float, *, tone: bool = True, lanes: int = _BLOCK_LANES):
    """The soft frame, ``[H, W, 3]``, in blocks of rows, without gradient."""
    with torch.no_grad():
        img = torch.cat([trace_rows(scene, cam, width, height, r0, n, depth, tau, tau_z)
                         for r0, n in row_blocks(height, width, lanes)])
        return tonemap(img) if tone else img


def loss_and_grads(scene: dict, params: dict, cam: dict, width: int, height: int, depth: int,
                   target: torch.Tensor, *, tau: float, tau_z: float, tone: bool = True,
                   lanes: int = _BLOCK_LANES, stats: list | None = None,
                   rows: int | None = None):
    """The mean squared error of the soft frame against ``target`` and its
    gradient in ``params`` (``center``, ``color``), block by block; with
    ``rows``, over the frame's first rows only."""
    for p in params.values():
        p.grad = None
    full = dict(scene, sph_center=params["center"], sph_color=params["color"])
    rows = height if rows is None else rows
    scale = 1.0 / (rows * width * 3)
    total = torch.zeros((), dtype=torch.float64, device=target.device)
    for r0, n in row_blocks(rows, width, lanes):
        img = trace_rows(full, cam, width, height, r0, n, depth, tau, tau_z, stats)
        if tone:
            img = tonemap(img)
        term = torch.sum((img - target[r0:r0 + n]) ** 2) * scale
        term.backward()
        total += term.detach().to(torch.float64)
    return total, {k: p.grad for k, p in params.items()}
