"""Image export and import, and terminal presentation."""

from raytracer_tpu_torch.io.images import (
    load_image,
    save_image,
    save_npy,
    save_png,
    save_ppm,
    to_u8,
)
from raytracer_tpu_torch.io.term import term_frame

__all__ = [
    "save_image",
    "save_png",
    "save_ppm",
    "save_npy",
    "load_image",
    "to_u8",
    "term_frame",
]
