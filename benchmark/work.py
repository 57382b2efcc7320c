"""The least time a function of the frame can take on one H100: its bytes
at the memory rate against its float32 operations at the float32 rate.

Operations are reckoned as the program's CUDA sources do them (each add,
mul, div, sqrt, rsqrt, exp, log, min, max and compare counts one), from
counts that the reference works out on the traced run's own inputs: each
level's alive lanes, their hits by kind, and the (ray, sphere) pairs of
nonzero soft coverage. Only the work that any implementation of the
function has to do is counted: each alive lane tests every wall, the sphere
it hits, shades its hit or looks up the sky; each covering (ray, sphere)
pair is composited once. No chunk, gate, shortlist or tile of the program
enters, so the bound reads the same work whatever implements the function.
Bytes count each input plane read once and each output plane written once.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: HBM3 bytes/s and float32 FLOP/s outside the
# tensor cores (an FMA counts two; the program builds with -fmad=false).
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12


def bound_s(ops: float, nbytes: float) -> float:
    """The least seconds: the larger of the two rates' times."""
    return max(ops / PEAK_F32_S, nbytes / PEAK_BYTES_S)


def _shade_hard(c: dict) -> int:
    return 49 * c["n_pt"] + 36 * c["n_sun"] + 35


def level_fwd(c: dict, levels: list, lanes: int) -> dict:
    """The hard trace of ``lanes`` camera rays through ``len(levels)``
    levels: reads the 7 ray planes, writes the rgb and each level's t and
    index; per alive lane the walls (39 each), the sky and the slab test
    (33), 25 more where its line meets the spheres' box, the hit sphere's
    test (22) and record (38) or the wall's record (22), the shading, and
    6 per miss."""
    shade = _shade_hard(c)
    ops = 0.0
    for lv in levels:
        ops += (19 + 39 * c["n_w"] + 14) * lv["alive"] + 25 * lv["used"]
        ops += (22 + 38 + shade) * lv["sphere"] + (22 + shade) * lv["wall"] + 6 * lv["miss"]
    nbytes = (7 + 3 + 2 * len(levels)) * lanes * 4
    return {"ops": ops, "bytes": nbytes, "s": bound_s(ops, nbytes)}


def _soft_shade(c: dict) -> int:
    return 6 + 66 * c["n_pt"] + 53 * c["n_sun"]


def soft_fwd(c: dict, levels: list) -> dict:
    """The soft levels: per lane every wall (its hit twice, 139, its
    shading and contribution) and the tail (88); per covering (ray, sphere)
    pair the hit for the anchor (58), again with the shading (55 + shade)
    and the contribution (37; 17 at the last level). Reads the 7 ray planes
    and the accumulator, writes the accumulator and, before the last level,
    the next 7 ray planes."""
    shade = _soft_shade(c)
    ops, nbytes = 0.0, 0.0
    for k, lv in enumerate(levels):
        last = k == len(levels) - 1
        contrib = 17 if last else 37
        per_lane = c["n_w"] * (139 + shade + contrib) + 88
        ops += per_lane * lv["lanes"] + (58 + 55 + shade + contrib) * lv["pairs"]
        nbytes += (10 + 3 + (0 if last else 7)) * lv["lanes"] * 4
    return {"ops": ops, "bytes": nbytes, "s": bound_s(ops, nbytes)}


def soft_bwd(c: dict, levels: list) -> dict:
    """The soft levels' backward: per lane the tail and its adjoint (170)
    and every wall's contribution again with its adjoint; per covering pair
    the hit (55), the shading twice, the lights' adjoint (9 + 130 per point
    light + 100 per sun), the contribution's adjoint (60; 30 at the last
    level), the hit's (65) and 12 cotangent sums. Reads the rays, the
    accumulator's cotangent and, before the last level, the next rays'
    cotangents; writes the 7 ray-plane cotangents."""
    shade = _soft_shade(c)
    adj = 9 + 130 * c["n_pt"] + 100 * c["n_sun"]
    ops, nbytes = 0.0, 0.0
    for k, lv in enumerate(levels):
        last = k == len(levels) - 1
        cb = 30 if last else 60
        per_lane = 170 + c["n_w"] * (68 + 2 * shade + adj + cb + 80 + 23)
        ops += per_lane * lv["lanes"] + (55 + 2 * shade + adj + cb + 65 + 12) * lv["pairs"]
        nbytes += (7 + 3 + (0 if last else 7) + 7) * lv["lanes"] * 4
    return {"ops": ops, "bytes": nbytes, "s": bound_s(ops, nbytes)}


def counts_of(arrays: dict) -> dict:
    """The primitive and light counts the formulas read."""
    return {"n_w": len(arrays["wall_length"]), "n_pt": len(arrays["light_pos"]),
            "n_sun": len(arrays["sun_dir"])}
