"""The hard fit cell ``grid1024-hardfit-4k-d4``: the program's hard fit at
the cell's depth against the plain reference, the cell run whole on the
CPU, and its readers of ``work.level_fwd`` and ``work.level_bwd``."""

import json
import time

import numpy as np
import pytest
import torch

from benchmark import harness, inputs
from benchmark.reference import common, hard
from benchmark.tests.tiny import tiny_spec

rt = pytest.importorskip("raytracer_tpu_torch")

CELL = "grid1024-hardfit-4k-d4"


@pytest.mark.parametrize("route", ["whole", "chain"])
def test_hard_fit_at_depth_4_matches_the_reference(route, monkeypatch):
    """A fit's loss and gradients at depth 4 on grid-16 at 48x27 (the size
    and tolerances of ``test_reference.test_fit_gradients``), through the
    whole-trace route and through the per-level chain that the cell's
    scene takes."""
    from raytracer_tpu_torch.ops import cuda_fold

    if route == "chain":
        monkeypatch.setattr(cuda_fold, "in_fused_class", lambda tables, depth: False)
    cfg = json.loads((harness.BENCH_DIR / "configs" / "grid-64.json").read_text())
    cfg["scene"]["n"] = 16
    arrays = inputs.scene_arrays(cfg)
    cam = {k: np.asarray(v, np.float32) for k, v in cfg["camera"].items()}
    scene, camera = rt.Scene.from_numpy(arrays, device="cpu"), rt.Camera.from_numpy(cam, "cpu")
    rscene, rcam = common.to_tensors(arrays, "cpu"), common.to_tensors(cam, "cpu")
    target = hard.render(rscene, rcam, 48, 27, 4)
    start = inputs.start_draw(arrays, 0.15, inputs.seeded_generator(7, "cpu"), "cpu")
    params = {k: v.clone().requires_grad_(True) for k, v in start.items()}
    img = rt.render(rt.merge_params(scene, params), camera, 48, 27, depth=4, device="cpu")
    kind = type(img.grad_fn).__name__
    loss = torch.mean((img - target) ** 2)
    loss.backward()
    mine = {k: v.clone().requires_grad_(True) for k, v in start.items()}
    want_loss, grads = hard.loss_and_grads(rscene, mine, rcam, 48, 27, 4, target, lanes=500)
    assert torch.isfinite(loss)
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-5 * float(want_loss), kind
    for k in params:
        scale = float(grads[k].abs().max())
        assert float((params[k].grad - grads[k]).abs().max()) <= 1e-4 * scale, k


@pytest.fixture(scope="module")
def cell_ctx():
    """One run of the cell cut to the CPU (``tiny_spec``): its result and
    the ``ctx`` its metric readers get."""
    seen = {}
    real = harness.read_metric

    def spy(bench_dir, name, ctx):
        seen.update(ctx)
        return real(bench_dir, name, ctx)

    harness.read_metric = spy
    try:
        spec = tiny_spec(CELL)
        out = harness.run_cell(spec, 2**35 + 11, 0.25, False, "cpu", time.perf_counter())
    finally:
        harness.read_metric = real
    return out, seen


def test_the_cell_is_correct_on_the_cpu(cell_ctx):
    out, ctx = cell_ctx
    t = tiny_spec(CELL).traffic
    assert t["kind"] == "fit" and not t["soft"] and t["first_steps"] == 2
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"first_loss_gap", "loss_gap", "change_gap", "grad_bad_share"}
    assert "step_ms" in out["metrics"] and "setup_s" in out["metrics"]


@pytest.mark.parametrize("metric, work", [("level_bwd_roofline", "level_bwd"),
                                          ("level_fwd_roofline.hardfit", "level_fwd")])
def test_the_rooflines_read_the_cells_work(cell_ctx, metric, work):
    """Each roofline reader divides the run's counted work by the device
    time of its kernels (``<metric>.kernels*.json``): on a trace of those
    kernels it reads between 0% and 100%, and nothing without its work or
    its kernels, as on a program before the hard fit's cell."""
    _, ctx = cell_ctx
    assert ctx["work"][work]["ops"] > 0 and ctx["work"][work]["s"] > 0
    secs = 1e3 * ctx["work"][work]["s"]
    trace = {"kernels": {"void rt::trace_level_bwd_kernel<256, 1>(rt::LevelBwdArgs)": secs,
                         "void rt::trace_level_kernel<256>(rt::LevelArgs)": secs,
                         "void rt::ray_stats_kernel<256>(rt::StatsArgs)": secs,
                         "void rt::soft_level_bwd_kernel<0>(rt::SoftBwdArgs)": secs}}
    got = harness.read_metric(harness.BENCH_DIR, metric, dict(ctx, trace=trace, traced=1))
    assert 0.0 < got < 100.0
    assert harness.read_metric(harness.BENCH_DIR, metric, dict(ctx, trace=None, traced=1)) is None
    empty = dict(ctx, trace={"kernels": {}}, traced=1)
    assert harness.read_metric(harness.BENCH_DIR, metric, empty) is None
    missing = dict(ctx, trace=trace, traced=1, work={})
    assert harness.read_metric(harness.BENCH_DIR, metric, missing) is None


@pytest.mark.parametrize("metric, want", [("span_ms.fit.level_bwd", 3.0),
                                          ("syncs.fit.hardfit", 1),
                                          ("idle_share.fit.hardfit", None)])
def test_the_span_and_counter_readers(metric, want, monkeypatch):
    """``span_ms.fit.level_bwd`` (the median a step of ``rt.level_bwd``)
    and ``syncs.fit.hardfit`` on a synthetic snapshot of three steps, None
    for a render and for a program without the registry;
    ``idle_share.fit.hardfit`` on a synthetic device trace."""
    from raytracer_tpu_torch.utils import profiler

    def step(k, syncs, bwd_ms):
        ms = 1_000_000
        spans = [("rt.fit_step", -1, 0, 20), ("rt.backward", 0, 5, 15),
                 ("rt.level_bwd", 1, 6, 6 + bwd_ms)]
        return {"id": k, "name": "rt.fit_step", "start_ns": 0, "end_ns": 20 * ms,
                "counters": {"syncs": syncs},
                "spans": [{"id": i, "parent": p, "name": n, "start_ns": a * ms,
                           "end_ns": b * ms, "tid": 1} for i, (n, p, a, b) in enumerate(spans)]}

    snap = {"dropped": {"spans": 0, "requests": 0},
            "requests": [step(0, 0, 2), step(1, 1, 3), step(2, 4, 8)]}
    if want is None:
        ctx = {"kind": "fit", "trace": {"window_s": 4.0, "busy_s": 1.0}}
        assert harness.read_metric(harness.BENCH_DIR, metric, ctx) == pytest.approx(75.0)
        return
    monkeypatch.setattr(profiler, "snapshot", lambda: snap)
    assert harness.read_metric(harness.BENCH_DIR, metric, {"kind": "fit"}) == pytest.approx(want)
    assert harness.read_metric(harness.BENCH_DIR, metric, {"kind": "render"}) is None
    monkeypatch.delattr(profiler, "snapshot")
    assert harness.read_metric(harness.BENCH_DIR, metric, {"kind": "fit"}) is None


def test_the_cells_configuration_is_c5s_scene_fitted():
    """The cell runs a configuration of its own, BASELINE c5 as a fit, on
    the scene and camera of the render cell's ``grid-1024``: the two differ
    only in what is named and assumed, and in the hosts over which the
    pixel tiles are sharded, listed in ``reduced``."""
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == "grid-1024-hardfit")
    assert entry["reduced"] == ["pixel_tile_hosts"]
    spec = harness.load_spec(CELL)
    base = json.loads((harness.BENCH_DIR / "configs" / "grid-1024.json").read_text())
    assert spec.config["name"] == "grid-1024-hardfit" != base["name"]
    assert spec.config["source"] != base["source"]
    for key in ("precision", "scene", "camera"):
        assert spec.config[key] == base[key]
    assert spec.config["pixel_tile_hosts"] == 1
