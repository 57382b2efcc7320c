"""3-vector math on trailing-axis-3 tensors (the API-boundary layout)."""

from __future__ import annotations

import torch

__all__ = ["length", "length_squared", "normalize", "cross"]


def length_squared(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return torch.sum(v * v, dim=-1, keepdim=keepdim)


def length(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return torch.sqrt(length_squared(v, keepdim=keepdim))


def normalize(v: torch.Tensor) -> torch.Tensor:
    """Unit vector along ``v``."""
    return v * torch.rsqrt(length_squared(v, keepdim=True))


def cross(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Cross product over the trailing xyz axis."""
    ux, uy, uz = u[..., 0], u[..., 1], u[..., 2]
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack(
        [uy * vz - uz * vy, uz * vx - ux * vz, ux * vy - uy * vx], dim=-1
    )
