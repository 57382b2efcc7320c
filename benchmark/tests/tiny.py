"""Cells of the benchmark cut to a size the CPU tests hold: the same files,
with fewer spheres, a small frame and a short walk of samples."""

from __future__ import annotations

import copy

from benchmark import harness

CELLS = ("grid1024-render-4k-d4", "grid64-softfit-1080p-d1", "grid1024-softfit-1080p-d1")
# A hard fit: the soft fit cell's files with the hard renderer at depth 2 (no
# cell of the benchmark runs one yet; the harness and the reference do).
HARD_FIT = "hardfit"
FITS = (*CELLS[1:], HARD_FIT)


def tiny_spec(cell: str, spheres: int = 16, width: int = 48, height: int = 27, **root):
    """``cell``'s spec with ``spheres`` spheres at ``width`` x ``height``
    and depth at most 2 (``HARD_FIT``: the hard fit at depth 2)."""
    hard = cell == HARD_FIT
    spec = harness.load_spec(CELLS[2] if hard else cell, **root)
    spec.config = copy.deepcopy(spec.config)
    spec.config["scene"]["n"] = spheres
    t = dict(spec.traffic, width=width, height=height, depth=min(spec.traffic["depth"], 2))
    if hard:
        t.update(soft=False, depth=2)
    spec.traffic = t
    return spec
