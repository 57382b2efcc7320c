"""Plain PyTorch math shared by the hard and the soft reference renderers.

Rays are ``[N, 3]`` tensors; a scene is the dict of tensors that
``inputs.scene_arrays`` makes (keys ``sph_*``, ``wall_*``, ``light_*``,
``sun_*`` and the sky), converted with ``to_tensors``. Every function
computes in the dtype of its inputs, so the same code is the float32
reference and, given bfloat16 tensors, its lower-precision control. Nothing
here imports the program under test.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MISS_T = 1e30  # the distance of a ray that hits nothing
REFLECT_EPS = 1e-4  # the offset of a mirror ray's origin along the normal
LUMA = (0.2126, 0.7152, 0.0722)  # Rec. 709 luminance weights


def strict_float32() -> None:
    """No TF32 in any matrix product: the reference is float32 throughout."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def to_tensors(arrays: dict, device, dtype=torch.float32) -> dict:
    """The scene's arrays as tensors of ``dtype`` on ``device``."""
    return {k: torch.as_tensor(np.asarray(v), device=device).to(dtype) for k, v in arrays.items()}


def normalize(v: torch.Tensor) -> torch.Tensor:
    return v * torch.rsqrt(torch.sum(v * v, dim=-1, keepdim=True))


def max_c(x: torch.Tensor, c: float) -> torch.Tensor:
    """``max(x, c)`` whose derivative at a tie ``x == c`` is half the
    cotangent (``torch.maximum``'s rule, the renderer's stated one)."""
    return torch.maximum(x, x.new_full((), c))


def min_c(x: torch.Tensor, c: float) -> torch.Tensor:
    """``min(x, c)``, half the cotangent at a tie."""
    return torch.minimum(x, x.new_full((), c))


def normalize_eps(v: torch.Tensor, eps: float) -> torch.Tensor:
    """``v / |v|`` with ``|v|^2`` held at ``eps`` or above."""
    return v * torch.rsqrt(max_c(torch.sum(v * v, dim=-1, keepdim=True), eps))


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def camera_rays(cam: dict, width: int, height: int, row0: int, rows: int):
    """Pinhole rays of rows ``[row0, row0 + rows)``: ``(origin [3], dirs
    [rows * W, 3])``. The direction points from the pixel centre to the
    camera (the upstream renderer's flip, which its demo layout needs); the
    frustum's height is ``2 tan(vfov / 2)`` times the look-at distance."""
    pos, look, vup = cam["position"], cam["lookat"], cam["vup"]
    focal = torch.sqrt(torch.sum((pos - look) ** 2))
    theta = cam["vfov"] * (math.pi / 180.0)
    fov_h = 2.0 * torch.tan(theta / 2.0) * focal
    fov_w = fov_h * (width / height)
    w = normalize(pos - look)
    u = normalize(torch.linalg.cross(vup, w))
    v = torch.linalg.cross(w, u)
    fx, fy = u * fov_w, v * (-fov_h)
    dx, dy = fx / width, fy / height
    top_left = pos - w * focal - fx / 2.0 - fy / 2.0 + (dx + dy) * 0.5
    jj = torch.arange(width, device=pos.device).to(pos.dtype)
    ii = torch.arange(row0, row0 + rows, device=pos.device).to(pos.dtype)
    centre = top_left + dx * jj[None, :, None] + dy * ii[:, None, None]
    return pos, normalize(pos - centre).reshape(-1, 3)


def wall_basis(normal: torch.Tensor):
    """(right, up) of each wall: ``normalize(n x z)``, ``normalize(right x n)``."""
    z = torch.zeros_like(normal)
    z[:, 2] = 1.0
    right = normalize(torch.linalg.cross(normal, z))
    up = normalize(torch.linalg.cross(right, normal))
    return right, up


def unit_suns(scene: dict) -> torch.Tensor:
    d = scene["sun_dir"]
    return normalize(d) if d.shape[0] else d


def light_terms(ldir, normal, view, exponent):
    """(diffuse, specular^exponent) of one unit light direction."""
    diffuse = max_c(dot(ldir, normal), 0.0)
    hv = view + ldir
    n2 = dot(hv, hv)
    half = hv * torch.rsqrt(torch.where(n2 > 1e-12, n2, 1.0))[..., None]
    base = max_c(dot(half, normal), 0.0)
    pos = base > 0.0
    spec = torch.where(pos, torch.exp(exponent * torch.log(torch.where(pos, base, 1.0))), 0.0)
    return diffuse, spec


def blinn_phong(point, normal, view, color, amb, kd, ks, expo, scene: dict, suns):
    """``color * (sum over lights of (diffuse kd + specular ks) * light
    colour + ambient)``: point lights, then suns (unit ``suns``)."""
    total = torch.zeros_like(point)
    for j in range(scene["light_pos"].shape[0]):
        ldir = normalize_eps(scene["light_pos"][j] - point, 1e-12)
        df, sp = light_terms(ldir, normal, view, expo)
        total = total + (df * kd + sp * ks)[..., None] * scene["light_color"][j]
    for j in range(suns.shape[0]):
        df, sp = light_terms(suns[j].expand_as(point), normal, view, expo)
        total = total + (df * kd + sp * ks)[..., None] * scene["sun_color"][j]
    return color * (total + amb[..., None])


def sky(d: torch.Tensor, scene: dict) -> torch.Tensor:
    """The ground colour below the horizon, ``horizon + (zenith - horizon)
    z^exponent`` above."""
    z = d[..., 2]
    g = torch.where(z > 0.0, torch.exp(scene["sky_exp"] * torch.log(torch.where(z > 0.0, z, 1.0))),
                    0.0)
    above = scene["horizon"] + (scene["zenith"] - scene["horizon"]) * g[..., None]
    return torch.where((z < 0.0)[..., None], scene["ground"].expand_as(above), above)


def tonemap(rgb: torch.Tensor) -> torch.Tensor:
    """Reinhard: ``c / (1 + max(luma(c), 0))``."""
    luma = LUMA[0] * rgb[..., 0] + LUMA[1] * rgb[..., 1] + LUMA[2] * rgb[..., 2]
    return rgb / (1.0 + max_c(luma, 0.0))[..., None]


def row_blocks(height: int, width: int, lanes: int):
    """``(row0, rows)`` blocks of about ``lanes`` rays each."""
    step = max(1, lanes // width)
    return [(r, min(step, height - r)) for r in range(0, height, step)]
