"""Spans and counters inside the program, timing on the card with CUDA
events, and the operator's views of both.

- The registry: spans at the program's layer boundaries (``request`` at an
  entry point, ``span`` inside it), counters (``count``, the kernels'
  launches ``count_launch``, and device-side counts a kernel adds into
  ``device_counters``), kept in memory in bounded rings while recording is
  on, read by ``snapshot``.
- Device time of a call, the frame time of a render, the forward and
  backward of the hard-path gradient, and the fit step, each on one device
  or sharded over a mesh (``parallel/mesh.py``), and the sharded frame over
  growing rank counts.
- Per-phase host timers (``PhaseTimer``) and a profiler trace of a block
  (``trace_capture``), both showing the registry's spans.
"""

from __future__ import annotations

import json
import os
import statistics
import threading
import time
import warnings
from collections import defaultdict, deque
from contextlib import contextmanager
from pathlib import Path

import torch

from raytracer_tpu_torch.core.types import Camera, Scene, resolve_device

__all__ = [
    "KERNELS",
    "request",
    "span",
    "count",
    "count_launch",
    "launches",
    "reset_launches",
    "device_counters",
    "recording",
    "snapshot",
    "reset",
    "span_totals_ns",
    "self_ns",
    "PhaseTimer",
    "trace_capture",
    "need_cuda",
    "cuda_time_ms",
    "benchmark_render",
    "benchmark_forward_backward",
    "benchmark_fit_step",
    "benchmark_scaling",
    "scaling_rows",
]

# Device cycles of the spin queued before each timed call (~0.5 ms at the
# H100's boost clock): long enough for the host to enqueue the call behind
# it, so the events bracket device work and not the host's enqueue.
_SPIN_CYCLES = 1_000_000

# ---------------------------------------------------------------------------
# The registry: spans and counters inside the program
# ---------------------------------------------------------------------------
#
# A request is the outermost program span: one ``render`` call or one fit
# step (``request`` at the entry point). Spans inside it (``span``) record
# their name, start, end, parent and the request's id; counters add into
# the request. Recording is on only while a ``torch.profiler`` session runs
# in the process, or inside ``recording()``; the check is made once, at
# the request's entry. With recording off, ``span`` is one global read that
# returns the shared no-op ``OFF``: no allocation and no clock read; only
# the launch counts count. Times are nanoseconds of the clock that
# ``torch.profiler`` stamps its host events with (Unix time), so a span can
# be placed on a profiler trace's timeline (``trace_capture``).

SPAN_RING = 1 << 16  # spans kept, over all requests
REQUEST_RING = 1 << 12  # requests kept
# The kernels whose launches ``count_launch`` counts.
KERNELS = ("trace_whole", "trace_whole_bwd", "ray_stats", "trace_level", "trace_level_bwd",
           "soft_level", "soft_level_bwd", "fold_flat", "fold_shortlist", "fold_shortlist_hit")
# What torch's sync debug mode warns with at a host sync.
_SYNC_WARNING = "called a synchronizing CUDA operation"

_autograd_profiler = torch.autograd.profiler  # ``_is_profiler_enabled``: a plain module global


class _Off:
    """The span of what is not recorded: it does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


class _Registry:
    """The process's recorded requests and spans (bounded rings, what they
    dropped counted), the launch counts, and the device rings of
    ``device_counters``."""

    def __init__(self):
        self.requests = deque()  # finished _Request objects, oldest first
        self.n_spans = 0  # spans the kept requests hold
        self.dropped = {"spans": 0, "requests": 0}
        self.launches = dict.fromkeys(KERNELS, 0)
        self.forced = 0  # open ``recording()`` blocks
        self.next_id = 0
        self.rings = {}  # (prefix, names, device): [int64 ring, next slot]
        self.open = None  # the request being recorded
        self.warned = {}  # the registry of warnings raised again after a request


_R = _Registry()


class _Span:
    """A recorded span of the open request ``req``."""

    __slots__ = ("req", "name", "id", "parent", "t0", "t1")

    def __init__(self, req, name: str):
        self.req, self.name = req, name

    def __enter__(self):
        req = self.req
        self.id = req.n_spans = req.n_spans + 1
        self.parent = req.stack[-1]
        req.stack.append(self.id)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.time_ns()
        req = self.req
        req.stack.pop()
        req.spans.append((self.id, self.parent, self.name, self.t0, self.t1,
                          threading.current_thread().native_id))
        return False


class _Request:
    """A recorded request: its spans (span 0 is the request itself), its
    counters, and the host syncs inside it (torch's sync debug mode at
    "warn" while it is open, its warnings counted as ``syncs``)."""

    def __init__(self, name: str):
        self.name = name
        self.spans, self.stack, self.n_spans = [], [0], 0
        self.counters = defaultdict(int)
        self.slots = {}  # ring key: slot index
        self._sync = None

    def __enter__(self):
        _R.next_id += 1
        self.id = _R.next_id
        _R.open = self
        if torch.cuda.is_initialized():
            self._sync = (torch.cuda.get_sync_debug_mode(), warnings.catch_warnings(record=True))
            self._caught = self._sync[1].__enter__()
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            self.counters["syncs"] = 0
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.time_ns()
        _R.open = None
        if self._sync is not None:
            mode, catcher = self._sync
            torch.cuda.set_sync_debug_mode(mode)
            catcher.__exit__(None, None, None)
            for w in self._caught:
                if _SYNC_WARNING in str(w.message):
                    self.counters["syncs"] += 1
                else:  # not ours to keep: warn as it would have
                    warnings.warn_explicit(w.message, w.category, w.filename, w.lineno,
                                           registry=_R.warned)
            self._sync = self._caught = None
        self.spans.insert(0, (0, -1, self.name, self.t0, self.t1,
                              threading.current_thread().native_id))
        self.stack = None
        _keep(self)
        return False


def _keep(req: _Request) -> None:
    """Append a finished request to the ring: the oldest requests, with
    their spans, go while more than ``REQUEST_RING`` requests or
    ``SPAN_RING`` spans are kept."""
    _R.requests.append(req)
    _R.n_spans += len(req.spans)
    while len(_R.requests) > REQUEST_RING or _R.n_spans > SPAN_RING:
        old = _R.requests.popleft()
        _R.n_spans -= len(old.spans)
        _R.dropped["requests"] += 1
        _R.dropped["spans"] += len(old.spans)


def request(name: str):
    """The span of a request (the outermost program span: one frame, one
    fit step): recorded while a ``torch.profiler`` session runs or inside
    ``recording()``, else ``OFF``. Inside a recorded request it is a span
    of that request."""
    req = _R.open
    if req is not None:
        return _Span(req, name)
    if not (_autograd_profiler._is_profiler_enabled or _R.forced):
        return OFF
    return _Request(name)


def span(name: str):
    """A span of the open request, or ``OFF`` when none is recorded."""
    req = _R.open
    return OFF if req is None else _Span(req, name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the open request's counter ``name`` (nothing when no
    request is recorded)."""
    req = _R.open
    if req is not None:
        req.counters[name] += n


def count_launch(kernel: str) -> None:
    """One launch of ``kernel`` (one of ``KERNELS``): counted always, and
    in the open request as ``launches.<kernel>``."""
    _R.launches[kernel] += 1
    req = _R.open
    if req is not None:
        req.counters["launches." + kernel] += 1


def launches(kernel: str | None = None):
    """The launches of ``kernel`` counted since ``reset_launches``, or a
    dict of every kernel's."""
    return dict(_R.launches) if kernel is None else _R.launches[kernel]


def reset_launches() -> None:
    for k in _R.launches:
        _R.launches[k] = 0


def device_counters(prefix: str, names: tuple, device):
    """Zeroed int64 counters ``[len(names)]`` on ``device`` that the open
    request owns (the same tensor on each call within it), for a kernel to
    add into; ``snapshot`` reads them as ``<prefix>.<name>``. None when no
    request is recorded. They are a slot of a ring on the device, so
    nothing is copied to the host while recording."""
    req = _R.open
    if req is None:
        return None
    key = (prefix, names, torch.device(device))
    ring = _R.rings.get(key)
    if ring is None:
        ring = _R.rings[key] = [torch.zeros((REQUEST_RING, len(names)), dtype=torch.int64,
                                            device=device), 0]
    slot = req.slots.get(key)
    if slot is None:
        slot = req.slots[key] = ring[1] % REQUEST_RING
        ring[1] += 1
        ring[0][slot].zero_()
    return ring[0][slot]


@contextmanager
def recording():
    """Record the requests of the block whether or not a profiler runs."""
    _R.forced += 1
    try:
        yield
    finally:
        _R.forced -= 1


def snapshot() -> dict:
    """The recorded requests, oldest first, and what the rings dropped:
    ``{"requests": [...], "dropped": {"spans", "requests"}}``. A request is
    ``{"id", "name", "start_ns", "end_ns", "spans", "counters"}``, its
    spans (itself first) ``{"id", "parent", "name", "start_ns", "end_ns",
    "tid"}`` (parent -1 for the request). Reads the device counters, so
    call it after recording."""
    host = {key: ring[0].cpu() for key, ring in _R.rings.items()}
    out = []
    for req in _R.requests:
        counters = dict(req.counters)
        for key, slot in req.slots.items():
            counters.update(zip((f"{key[0]}.{n}" for n in key[1]), host[key][slot].tolist()))
        out.append({"id": req.id, "name": req.name, "start_ns": req.t0, "end_ns": req.t1,
                    "spans": _span_dicts(req), "counters": counters})
    return {"requests": out, "dropped": dict(_R.dropped)}


def _span_dicts(req: _Request) -> list:
    return [{"id": sid, "parent": parent, "name": name, "start_ns": t0, "end_ns": t1, "tid": tid}
            for sid, parent, name, t0, t1, tid in req.spans]


def reset() -> None:
    """Forget every recorded request and span (not the launch counts)."""
    _R.requests.clear()
    _R.n_spans = 0
    _R.dropped = {"spans": 0, "requests": 0}


def span_totals_ns(req: dict) -> dict:
    """Nanoseconds of each span name in a ``snapshot`` request, summed over
    its spans of that name."""
    out = defaultdict(int)
    for s in req["spans"]:
        out[s["name"]] += s["end_ns"] - s["start_ns"]
    return dict(out)


def self_ns(req: dict, name: str) -> int:
    """The self time of the spans named ``name`` in a ``snapshot`` request:
    each one's duration less the part of it that its child spans cover,
    summed."""
    total = 0
    for s in req["spans"]:
        if s["name"] != name:
            continue
        covered, end = 0, s["start_ns"]
        for c0, c1 in sorted((c["start_ns"], c["end_ns"]) for c in req["spans"]
                             if c["parent"] == s["id"]):
            c0, c1 = max(c0, end), min(c1, s["end_ns"])
            if c1 > c0:
                covered += c1 - c0
                end = c1
        total += s["end_ns"] - s["start_ns"] - covered
    return total


@contextmanager
def trace_capture(out_dir=None, *, device=None):
    """``torch.profiler`` over the block, written to ``out_dir/trace.json``
    (Chrome trace format: Perfetto or chrome://tracing). It records the
    host's ops, the card's kernels when ``device`` (``None``: CUDA) is a
    CUDA device (the card is synchronized before the block ends), and the
    program's spans of the block's requests, each on its thread's row as an
    event of category ``program``. ``out_dir=None`` is a no-op, so a
    command-line flag can be passed straight through."""
    if not out_dir:
        yield
        return
    cuda = resolve_device(device).type == "cuda"
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    first = _R.next_id
    with torch.profiler.profile(activities=activities) as prof:
        yield
        if cuda:
            torch.cuda.synchronize()
    path = Path(out_dir) / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    for req in snapshot()["requests"]:
        if req["id"] <= first:
            continue
        for s in req["spans"]:
            trace["traceEvents"].append({
                "ph": "X", "cat": "program", "name": s["name"], "pid": pid, "tid": s["tid"],
                "ts": (s["start_ns"] - base) / 1e3, "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
                "args": {"request": req["id"], "span": s["id"], "parent": s["parent"]}})
    path.write_text(json.dumps(trace))


class PhaseTimer:
    """Wall-time samples per named phase, and their averages (the frame
    loop's exit report). A ``phase`` is a request of the registry with
    recording on for its block, so the report also gives the per-sample
    average of each program span inside it."""

    def __init__(self):
        self.samples: dict[str, list[float]] = defaultdict(list)
        # phase -> program span name -> seconds summed over the phase's samples
        self.spans: dict[str, dict[str, float]] = defaultdict(lambda: defaultdict(float))

    @contextmanager
    def phase(self, name: str):
        with recording():
            with request(name) as req:
                yield
        self.samples[name].append((req.t1 - req.t0) * 1e-9)
        if isinstance(req, _Request):  # a phase inside a recorded request is a span of it
            for sid, _, sname, t0, t1, _ in req.spans[1:]:
                self.spans[name][sname] += (t1 - t0) * 1e-9

    def record(self, name: str, seconds: float) -> None:
        self.samples[name].append(seconds)

    def averages(self) -> dict[str, float]:
        return {k: sum(v) / len(v) for k, v in self.samples.items() if v}

    def report(self) -> str:
        """One line a phase: its average in ms and its sample count; then
        one a program span inside a phase: its average over the phase's
        samples."""
        lines = [
            f"average {name} time: {avg * 1e3:.3f} ms  ({len(self.samples[name])} samples)"
            for name, avg in sorted(self.averages().items())
        ]
        for name, spans in sorted(self.spans.items()):
            n = len(self.samples[name])
            lines += [f"average {name} > {s} time: {v / n * 1e3:.3f} ms  ({n} samples)"
                      for s, v in sorted(spans.items())]
        return "\n".join(lines)

    def save(self, path) -> None:
        """Write the report, then each phase's samples in seconds, to a
        ``.log`` file."""
        with open(Path(path), "w") as f:
            f.write(self.report() + "\n\n")
            for name, vals in sorted(self.samples.items()):
                f.write(f"# {name} per-frame seconds\n")
                f.writelines(f"{v:.9f}\n" for v in vals)


def need_cuda(device=None) -> None:
    """Raise unless ``device`` (``None``: CUDA) is a CUDA device that is
    present: the timers here measure only on the card."""
    if torch.device("cuda" if device is None else device).type != "cuda":
        raise RuntimeError(f"timing on the card needs a CUDA device, not {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("timing on the card needs a CUDA device; none is available")


def cuda_time_ms(fn, *, iters: int = 10, warmup: int = 2) -> list[float]:
    """Device milliseconds of each of ``iters`` calls of ``fn()`` on the
    current stream, from a pair of CUDA events around each call, after
    ``warmup`` untimed calls."""
    need_cuda()
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(_SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in events]


def benchmark_render(
    scene: Scene,
    camera: Camera,
    width: int,
    height: int,
    *,
    depth: int = 3,
    iters: int = 10,
    fold: str = "auto",
    tonemap: bool = True,
    mesh=None,
) -> dict:
    """Forward-render throughput on the card: the median over ``iters``
    frames of the CUDA-event time from just before the ``render`` call (with
    the closest-hit ``fold``, as ``render`` takes it) to the end of its last
    device op, and primary rays/s at that frame time. Nothing is queued
    ahead of a frame, so host work that holds the device back counts in the
    frame. With a ``mesh`` the frame is ``render_sharded`` over it (every
    rank of the mesh calls this; each times its own call, which ends with
    the gather of every rank's tile)."""
    dev = _card(mesh)
    scene, camera = scene.to(dev), camera.to(dev)
    image = _image_fn(mesh, camera, width, height, depth=depth, tonemap=tonemap, fold=fold)
    with torch.no_grad():
        image(scene)
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        with torch.no_grad():
            image(scene)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    frame_ms = statistics.median(times)
    return {
        "frame_ms": frame_ms,
        "frame_ms_all": times,
        "primary_rays_per_s": width * height / (frame_ms * 1e-3),
        "pixels": width * height,
        "depth": depth,
        "fold": fold,
        "device": torch.cuda.get_device_name(0),
        **({} if mesh is None else {"mesh": _mesh_name(mesh)}),
    }


def _mesh_name(mesh) -> str:
    return "x".join(str(v) for v in mesh.devices.shape)


def _card(mesh) -> torch.device:
    """The device the timers run on, ``mesh.device`` or CUDA; raises unless
    it is a CUDA device that is present."""
    dev = torch.device("cuda") if mesh is None else mesh.device
    need_cuda(dev)
    return dev


def _image_fn(mesh, camera: Camera, width: int, height: int, **kw):
    """A scene's image: ``render``, or with a ``mesh`` ``render_sharded``."""
    from raytracer_tpu_torch.parallel.render import render_sharded
    from raytracer_tpu_torch.render.integrator import render

    if mesh is None:
        return lambda s: render(s, camera, width, height, **kw)
    return lambda s: render_sharded(s, camera, width, height, mesh=mesh, **kw)


def _calls_ms(fn, iters: int) -> float:
    """Milliseconds per call of ``iters`` back-to-back calls of ``fn()``,
    from CUDA events around them, started with nothing queued ahead: host
    work that holds the device back counts."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def benchmark_forward_backward(
    scene: Scene,
    camera: Camera,
    width: int,
    height: int,
    *,
    depth: int = 1,
    iters: int = 5,
    rounds: int = 3,
    fold: str = "auto",
    mesh=None,
) -> dict:
    """Three timings of the image-MSE loss with respect to the sphere
    centers and colours (the fit's parameters), on the card:

    - ``forward_ms``: the inference forward (no gradient wanted, so the
      forward kernel without residuals);
    - ``forward_train_ms``: the training forward, which runs the forward
      kernel with residuals and records the graph;
    - ``forward_backward_ms``: the training forward and the backward.

    ``backward_ms = forward_backward_ms - forward_train_ms`` and
    ``bwd_fwd_ratio = backward_ms / forward_ms``, as the JAX package's
    profiler defines them. The three are timed in turn within each of
    ``rounds`` rounds (``iters`` calls each, CUDA events), the difference
    and ratio are taken per round, and the medians over rounds reported.
    ``fold`` is the closest-hit fold, as ``render`` takes it. With a
    ``mesh`` the render is ``render_sharded`` over it, and the backward
    ends with the gradients summed over the mesh (every rank calls this).
    """
    from raytracer_tpu_torch.parallel import comm
    from raytracer_tpu_torch.parallel.train import default_params, merge_params

    dev = _card(mesh)
    scene, camera = scene.to(dev), camera.to(dev)
    image = _image_fn(mesh, camera, width, height, depth=depth, fold=fold)
    with torch.no_grad():
        target = image(scene)
    fixed = default_params(scene)
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in fixed.items()}

    def loss(params):
        return torch.mean((image(merge_params(scene, params)) - target) ** 2)

    def forward():
        with torch.no_grad():
            loss(fixed)

    def forward_train():
        loss(leaves)

    def forward_backward():
        grads = torch.autograd.grad(loss(leaves), list(leaves.values()))
        if mesh is not None:
            for g in grads:
                comm.all_sum(g, mesh.group)

    for fn in (forward, forward_train, forward_backward):
        fn()
    measured = []
    for _ in range(max(int(rounds), 1)):
        tf = _calls_ms(forward, iters)
        tt = _calls_ms(forward_train, iters)
        tb = _calls_ms(forward_backward, iters)
        bwd = max(tb - tt, 0.0)
        measured.append((tf, tt, tb, bwd, bwd / tf))
    cols = list(zip(*measured))
    med = [statistics.median(c) for c in cols]
    return {
        "forward_ms": med[0],
        "forward_train_ms": med[1],
        "forward_backward_ms": med[2],
        "backward_ms": med[3],
        "bwd_fwd_ratio": med[4],
        "forward_ms_rounds": list(cols[0]),
        "forward_train_ms_rounds": list(cols[1]),
        "forward_backward_ms_rounds": list(cols[2]),
        "bwd_fwd_ratio_rounds": list(cols[4]),
        "fwdbwd_over_fwd": med[2] / med[0],
        "pixels": width * height,
        "depth": depth,
        "device": torch.cuda.get_device_name(0),
        **({} if mesh is None else {"mesh": _mesh_name(mesh)}),
    }


def benchmark_fit_step(
    scene: Scene,
    camera: Camera,
    width: int,
    height: int,
    *,
    depth: int = 1,
    soft: bool = False,
    iters: int = 10,
    optimizer=None,
    mesh=None,
) -> dict:
    """Time of one ``make_fit_step`` step (render with gradients, the soft
    ``render_soft`` with ``soft``, backward, optimizer update; ``optimizer``
    and ``mesh`` as ``make_fit_step`` takes them, every rank of the mesh
    calling this) on the card: the median over ``iters`` steps of the CUDA
    event time from just before the step, with nothing queued ahead, to the
    end of its last device op, fitting ``scene`` to a black image."""
    from raytracer_tpu_torch.parallel.train import make_fit_step

    dev = _card(mesh)
    scene, camera = scene.to(dev), camera.to(dev)
    target = torch.zeros((height, width, 3), dtype=torch.float32, device=dev)
    init_fn, step_fn = make_fit_step(width, height, depth=depth, soft=soft, optimizer=optimizer,
                                     mesh=mesh)
    state = init_fn(scene)
    state, _ = step_fn(state, scene, camera, target)
    times = []
    for _ in range(iters):
        times.append(_calls_ms(lambda: step_fn(state, scene, camera, target), 1))
    return {
        "step_ms": statistics.median(times),
        "step_ms_all": times,
        "soft": soft,
        "depth": depth,
        "device": torch.cuda.get_device_name(0),
        **({} if mesh is None else {"mesh": _mesh_name(mesh)}),
    }


def scaling_rows(counts, frame_ms) -> list[dict]:
    """The scaling table of ``benchmark_scaling``: for each rank count and
    its frame time, primary-ray throughput as a ratio to the first row's
    (``frames_per_first``) and the efficiency against linear scaling from
    the first count, ``(1 / ms) / ((1 / ms0) * n / n0)``: 1.0 where ``n``
    ranks are ``n / n0`` times as fast as ``n0``, whatever ``n0`` is."""
    n0, ms0 = counts[0], frame_ms[0]
    return [{"devices": n, "frame_ms": ms, "frames_per_first": ms0 / ms,
             "scaling_efficiency": (ms0 / ms) / (n / n0)}
            for n, ms in zip(counts, frame_ms, strict=True)]


def benchmark_scaling(
    scene: Scene,
    camera: Camera,
    width: int,
    height: int,
    *,
    depth: int = 3,
    iters: int = 5,
    device_counts=None,
    device=None,
) -> list[dict]:
    """Rays/s of the sharded render on meshes of the first ``n`` ranks, for
    each ``n`` of ``device_counts`` (default 1, 2, 4, ... up to the world
    size), and the efficiency against linear scaling from the first count
    (``scaling_rows``). Every rank of the process group calls this: the
    meshes are made collectively; ranks outside a mesh wait. Rank 0, in
    every mesh, gives the rows (with primary rays/s); the others give []."""
    import torch.distributed as dist

    from raytracer_tpu_torch.parallel.mesh import make_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8, 16, 32, 64) if n <= world]
    times = []
    for n in device_counts:
        mesh = make_mesh(px=n, prim=1, ranks=range(n), device=device)
        if mesh.coords is not None:
            times.append(benchmark_render(scene, camera, width, height, depth=depth,
                                          iters=iters, mesh=mesh)["frame_ms"])
        if dist.is_initialized():
            dist.barrier()
    if dist.is_initialized() and dist.get_rank() != 0:
        return []
    rows = scaling_rows(device_counts, times)
    for row in rows:
        row["primary_rays_per_s"] = width * height / (row["frame_ms"] * 1e-3)
    return rows
