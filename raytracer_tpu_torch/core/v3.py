"""Component-structure-of-arrays 3-vectors.

Every per-ray quantity is kept as three same-shaped ``[rows, W]`` planes, one
per component, instead of a trailing axis of 3. The CUDA kernel reads each
plane with neighbouring threads on neighbouring addresses, and the plain
PyTorch version runs the same arithmetic plane by plane.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["V3"]


class V3(NamedTuple):
    """A 3-vector whose components are separate (same-shaped) tensors."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    @staticmethod
    def from_stacked(a: torch.Tensor) -> "V3":
        """From an ``[..., 3]`` tensor (the API-boundary layout)."""
        return V3(a[..., 0], a[..., 1], a[..., 2])

    def stacked(self) -> torch.Tensor:
        """To an ``[..., 3]`` tensor."""
        return torch.stack([self.x, self.y, self.z], dim=-1)

    def __add__(self, o: "V3") -> "V3":
        return V3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o: "V3") -> "V3":
        return V3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __mul__(self, s) -> "V3":
        """Every component times a scalar or a broadcastable tensor."""
        return V3(self.x * s, self.y * s, self.z * s)

    def dot(self, o: "V3") -> torch.Tensor:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def norm2(self) -> torch.Tensor:
        return self.dot(self)

    def normalized(self) -> "V3":
        return self * torch.rsqrt(self.norm2())

    def cross(self, o: "V3") -> "V3":
        return V3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    @staticmethod
    def where(pred: torch.Tensor, a: "V3", b: "V3") -> "V3":
        return V3(
            torch.where(pred, a.x, b.x),
            torch.where(pred, a.y, b.y),
            torch.where(pred, a.z, b.z),
        )

    def broadcast_to(self, shape) -> "V3":
        """Every component expanded to ``shape`` and made contiguous."""
        return V3(*(torch.broadcast_to(c, shape).contiguous() for c in self))
