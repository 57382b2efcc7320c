"""Scene definitions: the reference demo scene and procedural families.

Every factory builds its values with numpy in float32 and returns tensors on
``device`` (``None`` means CUDA). The values are the same as those of the
JAX package's factories of the same names, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from raytracer_tpu_torch.core.types import (
    Boxes,
    Camera,
    Lights,
    Materials,
    Scene,
    Sky,
    Spheres,
    Walls,
    resolve_device,
)

__all__ = [
    "reference_demo_scene",
    "reference_demo_camera",
    "sprint3_scene",
    "grid_sphere_scene",
    "random_sphere_scene",
    "logo_sphere_scene",
    "mixed_primitive_scene",
    "morton_sort",
]

LIGHT_POS = (0.0, 0.0, 0.0)
SUN_COLOR = (1.64, 1.27, 0.99)
SUN_DIRECTION = (0.7, 0.4, 0.7)


def _morton_key(q: np.ndarray) -> np.ndarray:
    """Interleave 10-bit quantized xyz coords into a 30-bit Morton code."""

    def spread(v):
        v = v.astype(np.uint64)
        v = (v | (v << 16)) & np.uint64(0x030000FF)
        v = (v | (v << 8)) & np.uint64(0x0300F00F)
        v = (v | (v << 4)) & np.uint64(0x030C30C3)
        v = (v | (v << 2)) & np.uint64(0x09249249)
        return v

    return spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) | (
        spread(q[:, 2]) << np.uint64(2)
    )


def morton_sort(centers: np.ndarray) -> np.ndarray:
    """Permutation ordering float32 ``[N, 3]`` centers along a Morton curve.

    Consecutive spheres become spatially adjacent, so the 16-sphere chunks
    the kernel gates over get compact bounding boxes. Sets of 8 or fewer
    spheres keep their order.
    """
    if len(centers) <= 8:
        return np.arange(len(centers))
    lo, hi = centers.min(axis=0), centers.max(axis=0)
    q = ((centers - lo) / np.maximum(hi - lo, 1e-9) * 1023.0).astype(np.uint32)
    return np.argsort(_morton_key(q), kind="stable")


def reference_demo_scene(*, sun: bool = False, device=None) -> Scene:
    """One green metallic sphere between a blue 1x1 wall and a green 2x2
    wall, lit by a white point light at the origin; ``sun=True`` adds the
    sun light."""
    spheres = Spheres.create(
        center=[[1.5, 0.0, 0.0]],
        radius=[0.5],
        material=Materials.create(color=[[0.0, 1.0, 0.0]], metallic=0.5),
    )
    walls = Walls.create(
        position=[[3.0, 2.0, 0.0], [3.0, -3.0, 0.0]],
        normal=[[0.0, -1.0, 0.0], [0.0, 1.0, 0.0]],
        length=[1.0, 2.0],
        width=[1.0, 2.0],
        material=Materials.create(color=[[0.0, 0.0, 1.0], [0.0, 1.0, 0.0]]),
    )
    lights = Lights.create(
        point_position=[LIGHT_POS],
        point_color=[(1.0, 1.0, 1.0)],
        sun_direction=SUN_DIRECTION,
        sun_color=SUN_COLOR if sun else None,
    )
    scene = Scene.create(spheres=spheres, walls=walls, lights=lights, sky=Sky.create())
    return scene.to(resolve_device(device))


def reference_demo_camera(device=None) -> Camera:
    """At the origin, looking at -x with vup -z, 90 degree vertical FOV."""
    return Camera.create(
        position=(0.0, 0.0, 0.0),
        lookat=(-1.0, 0.0, 0.0),
        vup=(0.0, 0.0, -1.0),
        vfov=90.0,
    ).to(resolve_device(device))


def sprint3_scene(device=None) -> Scene:
    """The demo geometry with the sun light enabled."""
    return reference_demo_scene(sun=True, device=device)


# The unit normal of (0, 1e-3, -1) — a ground slab tilted a little off z,
# because an exact z normal makes the wall basis degenerate. It is written
# out as the float32 value the JAX package's factories store (XLA's rsqrt on
# the CPU rounds z one ulp above the correctly rounded -0.99999952), so both
# packages render the very same scene.
_FLOOR_NORMAL = np.array([[0.0, 0.000999999581836164, -0.9999995827674866]], np.float32)


def _floor_walls() -> Walls:
    """A large ground slab below the spheres."""
    walls = Walls.create(
        position=[[-4.0, -10.0, 1.2]],
        normal=_FLOOR_NORMAL,
        length=[20.0],
        width=[20.0],
        material=Materials.create(color=[[0.4, 0.4, 0.45]], metallic=0.2),
    )
    return walls.replace(normal=torch.from_numpy(_FLOOR_NORMAL.copy()))


def _sun_lights(sun_direction=SUN_DIRECTION, sun: bool = True) -> Lights:
    return Lights.create(
        point_position=[(0.0, 0.0, 0.0)],
        point_color=[(1.0, 1.0, 1.0)],
        sun_direction=sun_direction,
        sun_color=SUN_COLOR if sun else None,
    )


def grid_sphere_scene(
    n: int,
    *,
    spacing: float = 1.2,
    radius: float = 0.5,
    distance: float = 8.0,
    metallic: float = 0.6,
    seed: int = 0,
    device=None,
) -> Scene:
    """``n`` reflective spheres in a jittered grid in the y/z plane at
    x = ``distance``, Morton-sorted, over a ground slab."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(n)))
    ys, zs = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    ys = (ys.ravel()[:n] - (side - 1) / 2.0) * spacing
    zs = (zs.ravel()[:n] - (side - 1) / 2.0) * spacing
    xs = distance + rng.uniform(-0.3, 0.3, size=n)
    centers = np.stack(
        [xs, ys + rng.uniform(-0.15, 0.15, n), zs + rng.uniform(-0.15, 0.15, n)],
        axis=-1,
    ).astype(np.float32)
    colors = rng.uniform(0.1, 1.0, size=(n, 3)).astype(np.float32)
    order = morton_sort(centers)
    spheres = Spheres.create(
        center=centers[order],
        radius=np.full((n,), radius, np.float32),
        material=Materials.create(color=colors[order], metallic=metallic),
    )
    scene = Scene.create(spheres=spheres, walls=_floor_walls(), lights=_sun_lights())
    return scene.to(resolve_device(device))


def random_sphere_scene(n: int, *, extent: float = 12.0, seed: int = 0, device=None) -> Scene:
    """``n`` spheres of random place, size, colour and metallic in a slab
    of space, Morton-sorted, over the ground slab."""
    rng = np.random.default_rng(seed)
    centers = np.stack(
        [
            rng.uniform(4.0, 4.0 + extent, n),
            rng.uniform(-extent, extent, n),
            rng.uniform(-extent / 2, extent / 2, n),
        ],
        axis=-1,
    ).astype(np.float32)
    radii = rng.uniform(0.2, 0.8, n).astype(np.float32)
    colors = rng.uniform(0.05, 1.0, (n, 3)).astype(np.float32)
    metallic = rng.uniform(0.1, 0.9, n).astype(np.float32)
    order = morton_sort(centers)
    spheres = Spheres.create(
        center=centers[order],
        radius=radii[order],
        material=Materials.create(color=colors[order], metallic=metallic[order]),
    )
    scene = Scene.create(spheres=spheres, walls=_floor_walls(), lights=_sun_lights())
    return scene.to(resolve_device(device))


# 5x7 bitmap glyphs for the logo scene (# = a sphere).
_GLYPHS = {
    "T": ["#####", "..#..", "..#..", "..#..", "..#..", "..#..", "..#.."],
    "U": ["#...#", "#...#", "#...#", "#...#", "#...#", "#...#", ".###."],
    "M": ["#...#", "##.##", "#.#.#", "#.#.#", "#...#", "#...#", "#...#"],
}


def logo_sphere_scene(
    text: str = "TUM",
    *,
    spacing: float = 0.55,
    radius: float = 0.26,
    distance: float = 7.0,
    metallic: float = 0.7,
    device=None,
) -> Scene:
    """Reflective spheres laid out as the block letters of ``text`` (5x7
    glyphs; an unknown character is a blank) at x = ``distance``, ambient
    0.25, lit by a sun from the camera's side."""
    ys, zs = [], []
    x_cursor = 0.0
    # y is negated below (the renderer mirrors the image horizontally),
    # which also reverses the letters, so lay the text out right to left.
    for ch in reversed(text.upper()):
        glyph = _GLYPHS.get(ch)
        if glyph is None:
            x_cursor += 3 * spacing
            continue
        for row, line in enumerate(glyph):
            for col, cell in enumerate(line):
                if cell == "#":
                    ys.append(x_cursor + col * spacing)
                    zs.append((3.0 - row) * spacing)
        x_cursor += (len(glyph[0]) + 1.5) * spacing
    n = len(ys)
    ys = -np.asarray(ys, np.float32)
    ys -= ys.mean()  # centred horizontally
    centers = np.stack(
        [np.full(n, distance, np.float32), ys, np.asarray(zs, np.float32)], axis=-1
    )
    spheres = Spheres.create(
        center=centers,
        radius=np.full((n,), radius, np.float32),
        material=Materials.create(
            color=np.tile(np.asarray([[0.35, 0.55, 0.95]], np.float32), (n, 1)),
            metallic=metallic,
            ambient=0.25,
        ),
    )
    scene = Scene.create(
        spheres=spheres, walls=_floor_walls(), lights=_sun_lights((-0.8, 0.2, -0.55))
    )
    return scene.to(resolve_device(device))


def mixed_primitive_scene(*, sun: bool = True, device=None) -> Scene:
    """Spheres, walls and boxes in one frame."""
    spheres = Spheres.create(
        center=[[4.0, -1.2, -0.2], [5.0, 1.5, 0.3]],
        radius=[0.6, 0.8],
        material=Materials.create(
            color=[[0.9, 0.3, 0.2], [0.2, 0.8, 0.4]], metallic=0.5
        ),
    )
    boxes = Boxes.create(
        minimum=[[3.2, 0.1, -0.9], [5.5, -2.6, -0.4]],
        maximum=[[4.2, 1.1, 0.1], [6.6, -1.4, 0.8]],
        material=Materials.create(
            color=[[0.95, 0.8, 0.25], [0.4, 0.5, 0.95]], metallic=0.35
        ),
    )
    scene = Scene.create(
        spheres=spheres, walls=_floor_walls(), boxes=boxes,
        lights=_sun_lights((-0.8, 0.2, -0.55), sun),
    )
    return scene.to(resolve_device(device))
