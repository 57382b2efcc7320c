"""Terminal frame presentation: ANSI truecolor half-blocks.

Two pixel rows make one text row: the upper-half-block glyph (U+2580) takes
the top pixel as its foreground colour and the bottom pixel as its
background. The bytes are those of the JAX package's presenter
(native/src/term_view.cpp and its Python path).
"""

from __future__ import annotations

import numpy as np

from raytracer_tpu_torch.io.images import to_u8

__all__ = ["term_frame"]


def term_frame(img, max_width: int = 120) -> str:
    """ANSI string showing the image at up to ``max_width`` columns."""
    a = to_u8(img)
    w = a.shape[1]
    if w > max_width:  # nearest-neighbour downscale for terminals
        step = -(-w // max_width)
        a = np.ascontiguousarray(a[::step, ::step])
    px = a.tolist()
    lines = []
    for y in range(0, len(px), 2):
        top = px[y]
        if y + 1 < len(px):
            row = [f"\x1b[38;2;{t[0]};{t[1]};{t[2]}m\x1b[48;2;{b[0]};{b[1]};{b[2]}m▀"
                   for t, b in zip(top, px[y + 1])]
        else:
            row = [f"\x1b[38;2;{t[0]};{t[1]};{t[2]}m\x1b[49m▀" for t in top]
        lines.append("".join(row) + "\x1b[0m")
    return "\n".join(lines) + "\n"
