"""What ``torch.profiler`` saw in the traced window: the device's activity
as intervals, its union (the busy time), the operations that took the most
device time, and the longest idle gaps named by what the host was doing.

Times are seconds. The window is the host span named ``WINDOW`` that the
harness records around the traced loop (``window_of`` says what stands in
for it where the host's ops were not recorded); the device is busy where
any kernel, copy or fill ran on it.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

WINDOW = "benchmark.window"
_NAME_CHARS = 160  # a kernel's or op's name as kept: the demangled signature's head
_GAPS_NAMED = 2000  # the longest idle gaps, each named by the innermost host op around it


def _attr(ev, name):
    v = getattr(ev, name)
    return v() if callable(v) else v


def _span_s(ev) -> tuple[float, float]:
    """(start, end) of a raw profiler event in seconds."""
    for start, dur, scale in (("start_ns", "duration_ns", 1e-9), ("start_us", "duration_us", 1e-6)):
        if hasattr(ev, start):
            s = _attr(ev, start) * scale
            return s, s + _attr(ev, dur) * scale
    tr = ev.time_range
    return tr.start * 1e-6, tr.end * 1e-6


def _on_device(ev) -> bool:
    return str(_attr(ev, "device_type")).upper().endswith("CUDA")


def events(prof) -> dict:
    """``{"device": [(name, start, end)], "host": [...]}`` from a finished
    ``torch.profiler.profile``."""
    results = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    raw = results.events() if results is not None else prof.events()
    out = {"device": [], "host": []}
    for ev in raw:
        s, e = _span_s(ev)
        name = str(_attr(ev, "name"))
        if _on_device(ev) and name == WINDOW:
            continue  # the window's own span, mirrored on the device's timeline
        out["device" if _on_device(ev) else "host"].append((name[:_NAME_CHARS], s, e))
    return out


def window_of(ev: dict) -> tuple[float, float] | None:
    """The ``WINDOW`` span where the host's ops were recorded; else the
    extent of every event (the device's, and the runtime calls that launch
    and wait for it), which starts at the window's first launch and ends
    with the synchronise that closes it."""
    spans = [(s, e) for n, s, e in ev["host"] if n == WINDOW]
    if not spans:
        spans = [(s, e) for n, s, e in ev["host"] + ev["device"]]
    return (min(s for s, _ in spans), max(e for _, e in spans)) if spans else None


def merged(intervals, lo: float, hi: float) -> list:
    """The union of ``(start, end)`` intervals clipped to ``[lo, hi]``, as
    disjoint sorted intervals."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summary(ev: dict, top: int = 10) -> dict | None:
    """``window_s``, ``busy_s`` (the union of device activity inside the
    window), ``kernels`` (device seconds by name inside the window), and the
    breakdown: ``device_ops`` and ``idle_gaps`` (the longest gaps' seconds
    by the innermost host op running at their midpoint), each at most
    ``top`` ``[name, seconds]`` pairs. None when the trace holds no window."""
    win = window_of(ev)
    if win is None:
        return None
    lo, hi = win
    dev = [(n, max(s, lo), min(e, hi)) for n, s, e in ev["device"] if e > lo and s < hi]
    busy = merged([(s, e) for _, s, e in dev], lo, hi)
    kernels = defaultdict(float)
    for n, s, e in dev:
        kernels[n] += e - s
    gaps, t = [], lo
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = e
    if hi > t:
        gaps.append((t, hi))
    host = [(n, s, e) for n, s, e in ev["host"] if n != WINDOW]
    hs = np.array([s for _, s, _ in host])
    he = np.array([e for _, _, e in host])
    by_host = defaultdict(float)
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:_GAPS_NAMED]:
        mid = 0.5 * (s + e)
        inside = np.flatnonzero((hs <= mid) & (he >= mid)) if host else []
        name = host[inside[np.argmin(he[inside] - hs[inside])]][0] if len(inside) else "no host op"
        by_host[name] += e - s
    return {
        "window_s": hi - lo,
        "busy_s": sum(e - s for s, e in busy),
        "kernels": dict(kernels),
        "device_ops": sorted(([n, v] for n, v in kernels.items()), key=lambda r: -r[1])[:top],
        "idle_gaps": sorted(([n, v] for n, v in by_host.items()), key=lambda r: -r[1])[:top],
    }
