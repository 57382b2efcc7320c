"""The plain hard reference's mirror bounce, the upstream's ``reflect``, and
the work the harness counts for a hard fit (``work.level_fwd`` and
``work.level_bwd``)."""

import json
import time

import numpy as np
import pytest
import torch

from benchmark import harness, inputs, work
from benchmark.reference import common, hard
from benchmark.tests.tiny import HARD_FIT, tiny_spec

# Pixels of grid-1024's 3840x2160 depth-4 frame whose mirror chain overflowed
# while the bounce took the normal as it came: (row, column).
FIREFLIES = ((1026, 536), (1046, 672), (1088, 272), (1548, 687))


def _config(name: str, spheres: int | None = None) -> dict:
    cfg = json.loads((harness.BENCH_DIR / "configs" / f"{name}.json").read_text())
    if spheres is not None:
        cfg["scene"]["n"] = spheres
    return cfg


def _grazing_bounce(scene: dict) -> torch.Tensor:
    """``|d_next| - 1`` of rays from the origin that pass the one sphere at
    0.9 to 0.9999 of its radius from its centre."""
    c, r = scene["sph_center"][0], float(scene["sph_radius"][0])
    side = torch.linalg.cross(c / c.norm(), torch.tensor([0.0, 0.0, 1.0]))
    side = side / side.norm()
    impact = torch.tensor([0.9, 0.99, 0.995, 0.999, 0.9995, 0.9999], dtype=torch.float64)
    d = common.normalize(c[None] + side[None] * (impact[:, None] * r).float())
    o = torch.zeros(3)
    t_sel, idx = hard.closest_hit(scene, common.wall_basis(scene["wall_normal"]), o, d)
    assert (idx == 0).all()
    _, _, _, d_next = hard._level(scene, common.unit_suns(scene), o, d, torch.ones(len(d)),
                                  t_sel, idx, False)
    return d_next.norm(dim=-1) - 1.0


def test_grazing_bounce_leaves_a_unit_direction(monkeypatch):
    scene = common.to_tensors(inputs.scene_arrays(_config("grid-64", spheres=1)), "cpu")
    assert float(_grazing_bounce(scene).abs().max()) <= 1e-6
    # The bounce with the normal as it comes, (p - c) / r, is not unit.
    monkeypatch.setattr(hard, "normalize", lambda v: v)
    assert float(_grazing_bounce(scene).abs().max()) > 1e-6


@pytest.mark.parametrize("row,col", FIREFLIES)
def test_c5_firefly_rows_are_finite(row, col):
    cfg = _config("grid-1024")
    scene = common.to_tensors(inputs.scene_arrays(cfg), "cpu")
    cam = common.to_tensors({k: np.asarray(v, np.float32) for k, v in cfg["camera"].items()},
                            "cpu")
    with torch.no_grad():
        img = hard.trace_rows(scene, cam, 3840, 2160, row, 1, 4)
    assert bool(torch.isfinite(img).all()), torch.nonzero(~torch.isfinite(img)).tolist()
    assert float(img[0, col].max()) < 10.0


def _hard_fit_work(monkeypatch, width: int, height: int) -> dict:
    """``ctx["work"]`` of one run of the tiny hard fit at ``width`` x
    ``height``, as the metric readers get it."""
    seen = {}
    real = harness.read_metric

    def spy(bench_dir, name, ctx):
        seen.update(ctx["work"])
        return real(bench_dir, name, ctx)

    spec = tiny_spec(HARD_FIT, width=width, height=height)
    with monkeypatch.context() as m:
        m.setattr(harness, "read_metric", spy)
        out = harness.run_cell(spec, 2**33 + 5, 0.25, False, "cpu", time.perf_counter())
    assert out["correct"], out["checks"]
    return seen


def test_hard_fit_counts_its_work(monkeypatch):
    pytest.importorskip("raytracer_tpu_torch")
    small = _hard_fit_work(monkeypatch, 48, 27)
    large = _hard_fit_work(monkeypatch, 96, 54)
    for key in ("level_fwd", "level_bwd"):
        for side in (small, large):
            assert side[key]["ops"] > 0 and side[key]["bytes"] > 0 and side[key]["s"] > 0
        assert large[key]["ops"] > small[key]["ops"]
        assert large[key]["bytes"] > small[key]["bytes"]


def test_level_bwd_on_hand_made_counts():
    c = {"n_s": 10, "n_w": 1, "n_pt": 1, "n_sun": 1}
    levels = [{"alive": 100, "sphere": 60, "wall": 30, "miss": 10, "used": 90, "lanes": 100},
              {"alive": 50, "sphere": 20, "wall": 5, "miss": 25, "used": 40, "lanes": 100}]
    out = work.level_bwd(c, levels, 100)
    hit = 88 + 180 + 135 + 14 + 6 * 2  # bounce, shading, the sums
    want_ops = (113 + hit) * (60 + 20) + (80 + hit) * (30 + 5) + 61 * (10 + 25)
    assert out["ops"] == want_ops == 63310
    # 7 ray planes and 3 rgb cotangents in, t and index of 2 levels, 7 ray
    # cotangents out, 6 cotangents a sphere.
    assert out["bytes"] == (7 + 3 + 4 + 7) * 100 * 4 + 6 * 10 * 4 == 8640
    assert out["s"] == max(want_ops / work.PEAK_F32_S, 8640 / work.PEAK_BYTES_S)
    # A lane that is not alive costs nothing; one more miss costs 61.
    levels[1]["miss"] += 1
    assert work.level_bwd(c, levels, 100)["ops"] == want_ops + 61
