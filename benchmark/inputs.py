"""The benchmark's inputs, made from a configuration, a traffic mix and the
seed: the scene's arrays, the camera's walk, and a fit's start.

Both sides get the very same numbers: the program as its ``Scene`` and
``Camera`` built from these arrays, the reference as tensors of them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["scene_arrays", "camera_walk", "camera_at", "start_draw", "seeded_generator"]


def _morton_order(centers: np.ndarray) -> np.ndarray:
    """Permutation ordering ``[N, 3]`` centres along a Morton curve of
    10-bit quantised coordinates (sets of 8 or fewer keep their order)."""
    if len(centers) <= 8:
        return np.arange(len(centers))
    lo, hi = centers.min(axis=0), centers.max(axis=0)
    q = ((centers - lo) / np.maximum(hi - lo, 1e-9) * 1023.0).astype(np.uint32)

    def spread(v):
        v = v.astype(np.uint64)
        for shift, mask in ((16, 0x030000FF), (8, 0x0300F00F), (4, 0x030C30C3), (2, 0x09249249)):
            v = (v | (v << np.uint64(shift))) & np.uint64(mask)
        return v

    key = spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) | (spread(q[:, 2]) << np.uint64(2))
    return np.argsort(key, kind="stable")


def _materials(prefix: str, color: np.ndarray, mat: dict) -> dict:
    n = color.shape[0]
    out = {prefix + "_color": color.astype(np.float32)}
    for key in ("ambient", "metallic", "diffuse", "specular", "exponent"):
        out[f"{prefix}_{key}"] = np.full((n,), mat[key], np.float32)
    return out


def scene_arrays(cfg: dict) -> dict:
    """The scene of a configuration as float32 arrays, keyed as the
    program's ``Scene.from_numpy`` takes them.

    ``grid_spheres``: ``n`` spheres in a jittered square grid in the y/z
    plane at x = ``distance`` (the jitter drawn from numpy's generator
    seeded with ``seed``: x, then y, then z offsets, then the colours),
    ordered along a Morton curve, over one floor wall; point lights, suns
    and the sky as the configuration states them."""
    s = cfg["scene"]
    if s["family"] != "grid_spheres":
        raise ValueError(f"unknown scene family {s['family']!r}")
    n = s["n"]
    rng = np.random.default_rng(s["seed"])
    side = int(np.ceil(np.sqrt(n)))
    ys, zs = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    ys = (ys.ravel()[:n] - (side - 1) / 2.0) * s["spacing"]
    zs = (zs.ravel()[:n] - (side - 1) / 2.0) * s["spacing"]
    jx, jyz = s["jitter_x"], s["jitter_yz"]
    xs = s["distance"] + rng.uniform(-jx, jx, size=n)
    centers = np.stack([xs, ys + rng.uniform(-jyz, jyz, n), zs + rng.uniform(-jyz, jyz, n)],
                       axis=-1).astype(np.float32)
    lo, hi = s["color_range"]
    colors = rng.uniform(lo, hi, size=(n, 3)).astype(np.float32)
    order = _morton_order(centers)
    out = {"sph_center": centers[order], "sph_radius": np.full((n,), s["radius"], np.float32)}
    out.update(_materials("sph", colors[order], dict(s["material"], metallic=s["metallic"])))
    walls = s["walls"]
    out["wall_position"] = np.asarray([w["position"] for w in walls], np.float32)
    out["wall_normal"] = np.asarray([w["normal"] for w in walls], np.float32)
    out["wall_length"] = np.asarray([w["length"] for w in walls], np.float32)
    out["wall_width"] = np.asarray([w["width"] for w in walls], np.float32)
    wall_mats = [dict(s["material"], **w["material"]) for w in walls]
    out["wall_color"] = np.asarray([m["color"] for m in wall_mats], np.float32)
    for key in ("ambient", "metallic", "diffuse", "specular", "exponent"):
        out["wall_" + key] = np.asarray([m[key] for m in wall_mats], np.float32)
    out["box_min"] = np.zeros((0, 3), np.float32)
    out["box_max"] = np.zeros((0, 3), np.float32)
    out.update(_materials("box", np.zeros((0, 3), np.float32), s["material"]))
    lights = s["lights"]
    out["light_pos"] = np.asarray(lights["point_position"], np.float32).reshape(-1, 3)
    out["light_color"] = np.asarray(lights["point_color"], np.float32).reshape(-1, 3)
    out["sun_dir"] = np.asarray(lights["sun_direction"], np.float32).reshape(-1, 3)
    out["sun_color"] = np.asarray(lights["sun_color"], np.float32).reshape(-1, 3)
    sky = s["sky"]
    out["ground"] = np.asarray(sky["ground"], np.float32)
    out["horizon"] = np.asarray(sky["horizon"], np.float32)
    out["zenith"] = np.asarray(sky["zenith"], np.float32)
    out["sky_exp"] = np.asarray(sky["exponent"], np.float32)
    return out


def _unit(v: np.ndarray) -> np.ndarray:
    return v / np.sqrt(np.sum(v * v))


def camera_walk(cam: dict, walk: list) -> np.ndarray:
    """The camera after each action of the viewer's walk, ``[A, 3, 3]``
    float32 (position, look-at point, up vector), computed in float64.

    ``walk`` is a list of ``[action, count, amount]``, the terminal
    viewer's key actions: ``forward`` and ``backward`` move position and
    look-at point together by ``amount`` along the look vector, ``left`` and
    ``right`` along ``cross(look, up)`` (the program's ``apply_action`` at
    its ``movement_speed``); ``yaw`` turns the look vector's xy part by
    ``amount`` radians about z and resets the up vector to ``((d x up) x d)``
    made unit (its ``rotate_left_right``, 0.1 rad a key press)."""
    pos = np.asarray(cam["position"], np.float64)
    look = np.asarray(cam["lookat"], np.float64)
    vup = np.asarray(cam["vup"], np.float64)
    out = []
    for action, count, amount in walk:
        for _ in range(count):
            d = look - pos
            if action in ("forward", "backward"):
                step = _unit(d) * amount * (1.0 if action == "forward" else -1.0)
                pos, look = pos + step, look + step
            elif action in ("left", "right"):
                step = _unit(np.cross(d, vup)) * amount * (1.0 if action == "right" else -1.0)
                pos, look = pos + step, look + step
            elif action == "yaw":
                base = math.hypot(d[0], d[1])
                a = math.atan2(d[1], d[0]) + amount
                nd = np.array([math.cos(a) * base, math.sin(a) * base, d[2]])
                vup = _unit(np.cross(np.cross(nd, vup), nd))
                look = pos + nd
            else:
                raise ValueError(f"unknown camera action {action!r}")
            out.append(np.stack([pos, look, vup]))
    return np.asarray(out, np.float32)


def camera_at(walk: np.ndarray, k: int, vfov: float) -> dict:
    """The camera of step ``k`` of the walk (taken round the loop) as
    float32 arrays: ``position``, ``lookat``, ``vup``, ``vfov``."""
    p = walk[k % len(walk)]
    return {"position": p[0], "lookat": p[1], "vup": p[2], "vfov": np.float32(vfov)}


def seeded_generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any whole number:
    taken modulo 2**63)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def start_draw(arrays: dict, perturb: float, g: torch.Generator, device) -> dict:
    """A fit's start: the true centres and colours plus uniform draws in
    ``[-perturb, perturb)`` (centres, then colours, from ``g``), colours
    clipped to [0, 1]; tensors on ``device``."""
    centre = torch.as_tensor(arrays["sph_center"], device=device)
    colour = torch.as_tensor(arrays["sph_color"], device=device)
    dc = (torch.rand(centre.shape, generator=g, device=device) * 2.0 - 1.0) * perturb
    dk = (torch.rand(colour.shape, generator=g, device=device) * 2.0 - 1.0) * perturb
    return {"center": centre + dc, "color": torch.clamp(colour + dk, 0.0, 1.0)}
