"""The span and counter registry inside the port (``utils/profiler.py``):
what it records and when, the span trees of a frame and of a soft fit step,
self time, the shared clock with ``torch.profiler``, the operator's views
(``trace_capture``, ``PhaseTimer``), and, on the card, the soft backward's
reach counts and the host-sync count.

CPU only, no JAX: tiny frames through the plain versions. The card's test
carries the ``chip`` marker and skips without a CUDA card; on the card:
``python -m pytest --noconftest -m chip tests/test_torch_tracing.py``.
"""

import json

import pytest
import torch

from raytracer_tpu_torch import make_fit_step, render
from raytracer_tpu_torch.models import scenes as tscenes
from raytracer_tpu_torch.ops import cuda_fold
from raytracer_tpu_torch.ops import trace as trace_ops
from raytracer_tpu_torch.utils import profiler

W, H = 32, 16
# The smallest grid scene outside the whole-trace class: its frames take the
# per-level chain, so phase A runs at every level.
GRID_PAST_CLASS = 769


@pytest.fixture(scope="module")
def past_class():
    scene = tscenes.grid_sphere_scene(GRID_PAST_CLASS, device="cpu")
    assert not cuda_fold.in_fused_class(cuda_fold.fused_tables(scene), 1)
    return scene, tscenes.reference_demo_camera(device="cpu")


def _frame(past_class):
    scene, camera = past_class
    with torch.no_grad():
        return render(scene, camera, W, H, depth=1, row_chunk=8, device="cpu")


def _soft_step():
    scene = tscenes.grid_sphere_scene(64, device="cpu")
    camera = tscenes.reference_demo_camera(device="cpu")
    target = torch.zeros((H - 8, W - 8, 3))
    init_fn, step_fn = make_fit_step(W - 8, H - 8, depth=1, soft=True, device="cpu")
    state = init_fn(scene)
    return lambda: step_fn(state, scene, camera, target)


def _recorded(fn) -> list:
    """The requests ``fn`` records under a CPU ``torch.profiler`` session."""
    profiler.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        fn()
    return profiler.snapshot()["requests"]


def _edges(req: dict) -> list:
    """Each span as (its name, its parent's name), sorted."""
    names = {s["id"]: s["name"] for s in req["spans"]}
    return sorted((s["name"], names.get(s["parent"])) for s in req["spans"])


def test_off_records_nothing_and_returns_the_shared_no_op(past_class):
    """With no profiler running and no ``recording()`` block, a request and
    a span are the one shared no-op, a counter does nothing, a frame
    records nothing; the launch counts still count."""
    profiler.reset()
    assert profiler.request("rt.render") is profiler.OFF
    assert profiler.span("rt.pack") is profiler.OFF
    profiler.count("syncs")
    before = profiler.launches("ray_stats")
    profiler.count_launch("ray_stats")
    assert profiler.launches("ray_stats") == before + 1
    assert profiler.device_counters("soft_bwd", ("lane_chunks",), "cpu") is None
    _frame(past_class)
    snap = profiler.snapshot()
    assert snap["requests"] == [] and snap["dropped"] == {"spans": 0, "requests": 0}


@pytest.mark.parametrize("work", ["render", "soft_fit_step"])
def test_span_tree_of_one_request(work, past_class):
    """Under a CPU profiler session a frame at 32x16 d1 in row chunks of 8
    rows (two chunks) is one request: ``rt.render`` over ``rt.raygen``,
    ``rt.pack`` and ``rt.trace`` once a chunk, ``rt.phase_a`` under
    ``rt.trace`` once a level and chunk. A c4-shaped soft fit step is one
    ``rt.fit_step``: ``rt.forward`` over the soft tables, ``rt.backward``
    over ``_SoftTrace``'s backward, ``rt.adam`` for the zeroing and the
    update. Every span carries the request's id."""
    if work == "render":
        reqs = _recorded(lambda: _frame(past_class))
        want = sorted([("rt.render", None)] + [("rt.raygen", "rt.render")] * 2
                      + [("rt.pack", "rt.render")] * 2 + [("rt.trace", "rt.render")] * 2
                      + [("rt.phase_a", "rt.trace")] * 4)
    else:
        step = _soft_step()
        reqs = _recorded(step)
        want = sorted([("rt.fit_step", None), ("rt.forward", "rt.fit_step"),
                       ("rt.raygen", "rt.forward"), ("rt.soft_pack", "rt.forward"),
                       ("rt.backward", "rt.fit_step"), ("rt.soft_bwd", "rt.backward")]
                      + [("rt.adam", "rt.fit_step")] * 2)
    assert len(reqs) == 1
    req = reqs[0]
    assert _edges(req) == want
    assert req["spans"][0]["parent"] == -1 and req["spans"][0]["name"] == req["name"]
    for s in req["spans"]:
        assert req["start_ns"] <= s["start_ns"] <= s["end_ns"] <= req["end_ns"]


def test_self_time_is_duration_less_child_coverage(past_class):
    """``self_ns``: a span's duration less the union of its children's
    intervals inside it (overlapping and overhanging children counted once);
    on a recorded frame, ``rt.render``'s self time and its children's
    durations add up to its duration."""
    req = {"spans": [
        {"id": 0, "parent": -1, "name": "r", "start_ns": 0, "end_ns": 100},
        {"id": 1, "parent": 0, "name": "a", "start_ns": 10, "end_ns": 30},
        {"id": 2, "parent": 0, "name": "a", "start_ns": 20, "end_ns": 40},
        {"id": 3, "parent": 0, "name": "b", "start_ns": 90, "end_ns": 120},
        {"id": 4, "parent": 1, "name": "c", "start_ns": 12, "end_ns": 14},
    ]}
    assert profiler.self_ns(req, "r") == 100 - 30 - 10
    assert profiler.self_ns(req, "a") == (20 - 2) + 20
    assert profiler.span_totals_ns(req) == {"r": 100, "a": 40, "b": 30, "c": 2}
    (frame,) = _recorded(lambda: _frame(past_class))
    top = [s for s in frame["spans"] if s["parent"] == 0]
    assert (profiler.self_ns(frame, "rt.render") + sum(s["end_ns"] - s["start_ns"] for s in top)
            == frame["end_ns"] - frame["start_ns"])


def test_trace_capture_puts_spans_on_the_profiler_clock(tmp_path, monkeypatch, past_class):
    """Under ``trace_capture`` every aten op the profiler recorded inside
    ``raygen_tile`` lies inside an exported ``rt.raygen`` span, to 20 us:
    the spans are stamped with the profiler's own host clock."""
    marker = "test.inside_raygen_tile"
    inner = trace_ops.raygen_tile

    def marked(*args, **kw):
        with torch.profiler.record_function(marker):
            return inner(*args, **kw)

    monkeypatch.setattr(trace_ops, "raygen_tile", marked)
    with profiler.trace_capture(tmp_path, device="cpu"):
        _frame(past_class)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = [e for e in events if e.get("cat") == "program" and e["name"] == "rt.raygen"]
    marks = [e for e in events if e.get("name") == marker and e.get("ph") == "X"]
    assert len(spans) == 2 and len(marks) == 2
    ops = [e for e in events if e.get("ph") == "X" and e.get("name", "").startswith("aten::")
           and any(m["ts"] <= e["ts"] and e["ts"] + e["dur"] <= m["ts"] + m["dur"]
                   for m in marks)]
    assert ops
    tol = 20.0
    for e in ops:
        assert any(s["ts"] - tol <= e["ts"] and e["ts"] + e["dur"] <= s["ts"] + s["dur"] + tol
                   for s in spans), e["name"]


def test_phase_timer_reports_program_spans_and_the_rings_count_drops(monkeypatch, past_class):
    """``PhaseTimer.phase`` records its block as a request: the report
    gives the phase's average and the average of each program span inside
    it. Past the rings' sizes the oldest requests go, counted."""
    timer = profiler.PhaseTimer()
    for _ in range(2):
        with timer.phase("raytracing"):
            _frame(past_class)
    report = timer.report()
    assert "average raytracing time" in report and "(2 samples)" in report
    for name in ("rt.render", "rt.raygen", "rt.pack", "rt.trace", "rt.phase_a"):
        assert f"average raytracing > {name} time" in report
    profiler.reset()
    monkeypatch.setattr(profiler, "REQUEST_RING", 3)
    with profiler.recording():
        for _ in range(5):
            with profiler.request("r"), profiler.span("s"):
                profiler.count("n", 2)
    snap = profiler.snapshot()
    assert [r["counters"] for r in snap["requests"]] == [{"n": 2}] * 3
    assert snap["dropped"] == {"requests": 2, "spans": 4}


@pytest.mark.chip
def test_soft_bwd_reach_counts_and_syncs_on_the_card():
    """On the card: ``soft_level_bwd``'s reach counts equal the plain
    counts of ``chip_smoke.reach_stats`` on a small grid-1024 frame
    (480x270, the camera level and the bounce level, in the natural order
    and in ``soft_lane_order``), and one planted ``.item()`` inside a
    request counts one host sync."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke
    from raytracer_tpu_torch.core.v3 import V3
    from raytracer_tpu_torch.ops import cuda_soft

    dev = "cuda"
    scene = tscenes.grid_sphere_scene(1024, device=dev)
    tau, tau_z = chip_smoke.SOFT_TAU, chip_smoke.SOFT_TAU_Z
    with torch.no_grad():
        tables = cuda_soft.soft_tables(scene, tau, tau_z)
        gates = cuda_soft.soft_gate_tables(scene, tau)
        o, d, w = chip_smoke.frame_rays(480, 270, dev)
        o, d = V3(*(c.contiguous() for c in o)), V3(*(c.contiguous() for c in d))
        acc = V3(*(torch.zeros_like(w) for _ in range(3)))
        out0 = cuda_soft.soft_level(tables, gates, o, d, w, acc, False, True)
        o1, d1, w1 = out0[2], out0[3], out0[1]
        out1 = cuda_soft.soft_level(tables, gates, o1, d1, w1, out0[0], True, True)
    gen = torch.Generator(device=dev).manual_seed(0)
    ct = V3(*(torch.randn(w.shape, generator=gen, device=dev) for _ in range(3)))
    cases = [(o1, d1, w1, out1[4], True, None), (o1, d1, w1, out1[4], True,
                                                   cuda_soft.soft_lane_order(o1, d1)),
             (o, d, w, out0[4], False, None)]
    ct_next = None
    for oo, dd, ww, res, last, order in cases:
        sums = torch.zeros(tables.packed.shape, dtype=torch.float64, device=dev)
        profiler.reset()
        with profiler.recording(), profiler.request("test.soft_bwd"):
            cts = cuda_soft.soft_level_bwd(tables, gates, oo, dd, ww, res, ct,
                                           None if last else ct_next, last, sums, order)
        if last and order is None:
            ct_next = cts
        (req,) = profiler.snapshot()["requests"]
        want = chip_smoke.reach_stats(tables, gates, oo, dd, order)
        got = req["counters"]
        assert got["soft_bwd.lanes"] == ww.numel()
        assert got["soft_bwd.lane_chunks"] == want["lane_pairs"] > 0
        assert got["soft_bwd.warp_chunks"] == want["warp_pairs"]
        assert got["syncs"] == 0
    x = torch.ones(4, device=dev)
    profiler.reset()
    with profiler.recording():
        with profiler.request("test.sync"):
            x.sum().item()
        with profiler.request("test.no_sync"):
            x.add_(1.0)
    assert [r["counters"]["syncs"] for r in profiler.snapshot()["requests"]] == [1, 0]
