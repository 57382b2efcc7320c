"""Scene, material, light and camera dataclasses of float32 tensors.

The scene is a structure of arrays: every primitive attribute is a stacked
``[N, ...]`` tensor, so the intersection tests run batched over rays and
primitives. Each class is a frozen dataclass with ``replace`` and
``to(device)``; ``Scene.from_numpy`` and ``Camera.from_numpy`` take the plain
numpy form of a scene or camera, so two implementations can render the very
same float32 inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from raytracer_tpu_torch.core import math3

__all__ = [
    "resolve_device",
    "Materials",
    "Spheres",
    "Walls",
    "Boxes",
    "Lights",
    "Sky",
    "Scene",
    "Camera",
    "CameraFrame",
]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means CUDA.

    Raises ``RuntimeError`` when CUDA is asked for (or defaulted to) and is
    absent; callers that want the plain CPU version pass ``device="cpu"``.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch version on the CPU"
        )
    return device


def _f32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _rows3(x) -> torch.Tensor:
    """An ``[N, 3]`` float32 tensor (a single 3-vector becomes one row)."""
    return torch.atleast_2d(_f32(x))


def _fill(x, n: int) -> torch.Tensor:
    """Broadcast a scalar or length-``n`` value to an owned ``[n]`` tensor."""
    return _f32(x).expand(n).clone()


class _Tensors:
    """``replace``/``to``/``tensors`` for frozen dataclasses of tensors."""

    def replace(self, **kwargs):
        return dataclasses.replace(self, **kwargs)

    def to(self, device):
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
        })

    def tensors(self) -> Iterator[torch.Tensor]:
        """Every tensor leaf, depth first in field order."""
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, _Tensors):
                yield from v.tensors()
            else:
                yield v


@dataclasses.dataclass(frozen=True)
class Materials(_Tensors):
    """Per-primitive Blinn-Phong parameters, stacked."""

    color: torch.Tensor  # f32[N, 3]
    ambient: torch.Tensor  # f32[N]
    metallic: torch.Tensor  # f32[N]
    diffuse: torch.Tensor  # f32[N]
    specular: torch.Tensor  # f32[N]
    specular_exponent: torch.Tensor  # f32[N]

    @staticmethod
    def create(
        color,
        metallic=0.5,
        ambient=0.1,
        diffuse=0.9,
        specular=0.4,
        specular_exponent=50.0,
    ) -> "Materials":
        color = _rows3(color)
        n = color.shape[0]
        return Materials(
            color=color,
            ambient=_fill(ambient, n),
            metallic=_fill(metallic, n),
            diffuse=_fill(diffuse, n),
            specular=_fill(specular, n),
            specular_exponent=_fill(specular_exponent, n),
        )

    def __len__(self) -> int:
        return self.ambient.shape[0]


def _no_material() -> Materials:
    return Materials.create(np.zeros((0, 3), np.float32))


@dataclasses.dataclass(frozen=True)
class Spheres(_Tensors):
    center: torch.Tensor  # f32[N, 3]
    radius: torch.Tensor  # f32[N]
    material: Materials

    @staticmethod
    def create(center, radius, material: Materials) -> "Spheres":
        center = _rows3(center)
        return Spheres(center, _fill(radius, center.shape[0]), material)

    @staticmethod
    def empty() -> "Spheres":
        return Spheres(
            torch.zeros((0, 3)), torch.zeros((0,)), _no_material()
        )

    def __len__(self) -> int:
        return self.radius.shape[0]


@dataclasses.dataclass(frozen=True)
class Walls(_Tensors):
    """Finite rectangles: a corner ``position``, a unit ``normal`` and the
    in-plane extents ``length`` x ``width``. The in-plane basis is
    ``right = normalize(cross(normal, z))``, ``up = normalize(cross(right,
    normal))`` — degenerate for normals parallel to z."""

    position: torch.Tensor  # f32[M, 3]
    normal: torch.Tensor  # f32[M, 3] unit
    length: torch.Tensor  # f32[M]
    width: torch.Tensor  # f32[M]
    material: Materials

    @staticmethod
    def create(position, normal, length, width, material: Materials) -> "Walls":
        position = _rows3(position)
        m = position.shape[0]
        normal = math3.normalize(_rows3(normal)).expand(m, 3).clone()
        return Walls(position, normal, _fill(length, m), _fill(width, m), material)

    @staticmethod
    def empty() -> "Walls":
        z = torch.zeros((0,))
        return Walls(torch.zeros((0, 3)), torch.zeros((0, 3)), z, z, _no_material())

    def __len__(self) -> int:
        return self.length.shape[0]


@dataclasses.dataclass(frozen=True)
class Boxes(_Tensors):
    """Axis-aligned boxes; outside hits only (the entry distance)."""

    minimum: torch.Tensor  # f32[N, 3]
    maximum: torch.Tensor  # f32[N, 3]
    material: Materials

    @staticmethod
    def create(minimum, maximum, material: Materials) -> "Boxes":
        lo, hi = _rows3(minimum), _rows3(maximum)
        return Boxes(torch.minimum(lo, hi), torch.maximum(lo, hi), material)

    @staticmethod
    def empty() -> "Boxes":
        return Boxes(torch.zeros((0, 3)), torch.zeros((0, 3)), _no_material())

    def __len__(self) -> int:
        return self.minimum.shape[0]


@dataclasses.dataclass(frozen=True)
class Lights(_Tensors):
    """Point lights plus sun lights. ``sun_direction`` points toward the sun
    and need not be unit; ``[0, 3]`` sun arrays disable the sun."""

    point_position: torch.Tensor  # f32[L, 3]
    point_color: torch.Tensor  # f32[L, 3]
    sun_direction: torch.Tensor  # f32[S, 3]
    sun_color: torch.Tensor  # f32[S, 3]

    @staticmethod
    def create(
        point_position=((0.0, 0.0, 0.0),),
        point_color=((1.0, 1.0, 1.0),),
        sun_direction=(0.7, 0.4, 0.7),
        sun_color=None,
    ) -> "Lights":
        """``sun_color=None`` (or all zeros) disables the sun."""
        if sun_color is None or not np.any(np.asarray(sun_color)):
            sun_direction = sun_color = np.zeros((0, 3), np.float32)
        return Lights(
            _rows3(point_position), _rows3(point_color),
            _rows3(sun_direction), _rows3(sun_color),
        )


@dataclasses.dataclass(frozen=True)
class Sky(_Tensors):
    """Sky gradient over a flat ground: rays with direction z < 0 see
    ``ground_color``, others ``lerp(horizon, zenith, z ** exponent)``."""

    ground_color: torch.Tensor  # f32[3]
    horizon_color: torch.Tensor  # f32[3]
    zenith_color: torch.Tensor  # f32[3]
    gradient_exponent: torch.Tensor  # f32[]

    @staticmethod
    def create(
        ground_color=(0.025, 0.05, 0.075),
        horizon_color=(0.36, 0.45, 0.57),
        zenith_color=(0.14, 0.21, 0.49),
        gradient_exponent=0.25,
    ) -> "Sky":
        return Sky(
            _f32(ground_color), _f32(horizon_color), _f32(zenith_color),
            _f32(gradient_exponent),
        )


@dataclasses.dataclass(frozen=True)
class Scene(_Tensors):
    spheres: Spheres
    walls: Walls
    boxes: Boxes
    lights: Lights
    sky: Sky

    @staticmethod
    def create(
        spheres: Spheres | None = None,
        walls: Walls | None = None,
        boxes: Boxes | None = None,
        lights: Lights | None = None,
        sky: Sky | None = None,
    ) -> "Scene":
        return Scene(
            spheres=spheres if spheres is not None else Spheres.empty(),
            walls=walls if walls is not None else Walls.empty(),
            boxes=boxes if boxes is not None else Boxes.empty(),
            lights=lights if lights is not None else Lights.create(),
            sky=sky if sky is not None else Sky.create(),
        )

    @property
    def num_primitives(self) -> int:
        return len(self.spheres) + len(self.walls) + len(self.boxes)

    @staticmethod
    def from_numpy(d: dict, device=None) -> "Scene":
        """Build from the plain dict of float32 arrays keyed ``sph_*``,
        ``wall_*``, ``box_*``, ``light_*``, ``sun_*`` and the sky colours —
        the numpy form of a scene. Values are taken exactly as given."""
        t = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in d.items()}

        def mat(p):
            return Materials(
                t[p + "_color"], t[p + "_ambient"], t[p + "_metallic"],
                t[p + "_diffuse"], t[p + "_specular"], t[p + "_exponent"],
            )

        scene = Scene(
            spheres=Spheres(t["sph_center"], t["sph_radius"], mat("sph")),
            walls=Walls(
                t["wall_position"], t["wall_normal"], t["wall_length"],
                t["wall_width"], mat("wall"),
            ),
            boxes=Boxes(t["box_min"], t["box_max"], mat("box")),
            lights=Lights(
                t["light_pos"], t["light_color"], t["sun_dir"], t["sun_color"]
            ),
            sky=Sky(t["ground"], t["horizon"], t["zenith"], t["sky_exp"]),
        )
        return scene.to(resolve_device(device))


@dataclasses.dataclass(frozen=True)
class Camera(_Tensors):
    """Pinhole look-at camera; the image size is an argument of ``render``."""

    position: torch.Tensor  # f32[3]
    lookat: torch.Tensor  # f32[3]
    vup: torch.Tensor  # f32[3]
    vfov: torch.Tensor  # f32[] vertical field of view, degrees
    movement_speed: torch.Tensor  # f32[]

    @staticmethod
    def create(
        position=(0.0, 0.0, 0.0),
        lookat=(-1.0, 0.0, 0.0),
        vup=(0.0, 0.0, -1.0),
        vfov=90.0,
        movement_speed=0.1,
    ) -> "Camera":
        return Camera(
            _f32(position), _f32(lookat), _f32(vup), _f32(vfov),
            _f32(movement_speed),
        )

    @staticmethod
    def from_numpy(d: dict, device=None) -> "Camera":
        """Build from a dict of the camera's fields as float32 arrays
        (``movement_speed`` may be left out)."""
        return Camera.create(
            d["position"], d["lookat"], d["vup"], d["vfov"],
            d.get("movement_speed", 0.1),
        ).to(resolve_device(device))


@dataclasses.dataclass(frozen=True)
class CameraFrame(_Tensors):
    """Per-frame ray-generation anchors derived from a ``Camera``."""

    origin: torch.Tensor  # f32[3]
    image_top_left: torch.Tensor  # f32[3] center of pixel (0, 0)
    pixel_delta_x: torch.Tensor  # f32[3]
    pixel_delta_y: torch.Tensor  # f32[3]
