"""Reinhard tone mapping and display-format conversion."""

from __future__ import annotations

import torch

__all__ = ["reinhard_tonemap", "to_uint8"]

# Rec. 709 luminance weights.
_LUMA = (0.2126, 0.7152, 0.0722)


def reinhard_tonemap(rgb: torch.Tensor) -> torch.Tensor:
    """Reinhard global operator ``c / (1 + luma(c))`` on ``[..., 3]``
    radiance: maps luma from [0, inf) into [0, 1) while keeping the hue (a
    very bright, strongly coloured pixel can exceed 1 in one channel)."""
    luma = (
        _LUMA[0] * rgb[..., 0] + _LUMA[1] * rgb[..., 1] + _LUMA[2] * rgb[..., 2]
    )[..., None]
    return rgb / (1.0 + torch.clamp_min(luma, 0.0))


def to_uint8(rgb: torch.Tensor) -> torch.Tensor:
    """Clamp to [0, 1] and quantize to u8 for display or PNG export."""
    return (torch.clamp(rgb, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
