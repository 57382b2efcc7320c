"""The readers of the program's span registry (``metrics/_spans.py`` and the
``span_ms.*``, ``syncs.*`` and ``soft_bwd_*`` metrics): None for the other
kind of traffic, for an empty snapshot and for a program without the
registry; the median a request on a synthetic snapshot."""

import pytest

from benchmark import harness

profiler = pytest.importorskip("raytracer_tpu_torch.utils.profiler")

MS = 1_000_000  # ns


def _request(name: str, spans: list, counters: dict, scale: int) -> dict:
    """A snapshot request from ``(name, parent index, start ms, end ms)``
    rows (the request's own span first), its times times ``scale``."""
    return {"id": scale, "name": name, "start_ns": 0, "end_ns": spans[0][3] * scale * MS,
            "counters": counters,
            "spans": [{"id": i, "parent": p, "name": n, "start_ns": int(a * scale * MS),
                       "end_ns": int(b * scale * MS), "tid": 1}
                      for i, (n, p, a, b) in enumerate(spans)]}


RENDER = [("rt.render", -1, 0, 10),
          ("rt.raygen", 0, 0, 1), ("rt.pack", 0, 1, 2), ("rt.trace", 0, 2, 5),
          ("rt.phase_a", 3, 2, 3),
          ("rt.raygen", 0, 5, 6), ("rt.pack", 0, 6, 7), ("rt.trace", 0, 7, 9),
          ("rt.phase_a", 7, 7, 7.5)]
FIT = [("rt.fit_step", -1, 0, 10), ("rt.adam", 0, 0, 0.5), ("rt.forward", 0, 0.5, 4),
       ("rt.raygen", 2, 0.5, 1), ("rt.soft_pack", 2, 1, 2), ("rt.backward", 0, 4, 9),
       ("rt.soft_bwd", 5, 4.5, 8.5), ("rt.adam", 0, 9, 10)]
SNAPSHOT = {"dropped": {"spans": 0, "requests": 0}, "requests": [
    _request("rt.render", RENDER, {"syncs": s}, k + 1) for k, s in enumerate((0, 3, 1))] + [
    _request("rt.fit_step", FIT, {"syncs": s, "soft_bwd.lanes": 1000,
                                  "soft_bwd.lane_chunks": lc, "soft_bwd.warp_chunks": wc}, k + 1)
    for k, (s, lc, wc) in enumerate(((2, 4000, 250), (0, 5000, 400), (5, 6000, 300)))]}

# metric: (the traffic kind it reads, its median on SNAPSHOT)
WANT = {
    "span_ms.render.raygen": ("render", 4.0), "span_ms.render.pack": ("render", 4.0),
    "span_ms.render.trace": ("render", 10.0), "span_ms.render.phase_a": ("render", 3.0),
    "span_ms.render.self": ("render", 2.0), "syncs.render": ("render", 1),
    "span_ms.fit.forward": ("fit", 7.0), "span_ms.fit.soft_pack": ("fit", 2.0),
    "span_ms.fit.backward": ("fit", 10.0), "span_ms.fit.soft_bwd": ("fit", 8.0),
    "span_ms.fit.adam": ("fit", 3.0), "syncs.fit": ("fit", 2), "syncs.fit.grid1024": ("fit", 2),
    "soft_bwd_chunks_per_lane.grid1024": ("fit", 5.0),
    "soft_bwd_warp_waste.grid1024": ("fit", 2.0),
}


def _read(name: str, kind: str):
    return harness.read_metric(harness.BENCH_DIR, name, {"kind": kind})


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader(name, monkeypatch):
    kind, want = WANT[name]
    other = {"render": "fit", "fit": "render"}[kind]
    monkeypatch.setattr(profiler, "snapshot", lambda: SNAPSHOT)
    assert _read(name, kind) == pytest.approx(want, rel=1e-12)
    assert _read(name, other) is None
    monkeypatch.setattr(profiler, "snapshot", lambda: {"requests": [], "dropped": {}})
    assert _read(name, kind) is None
    monkeypatch.delattr(profiler, "snapshot")  # a program from before the registry
    assert _read(name, kind) is None
