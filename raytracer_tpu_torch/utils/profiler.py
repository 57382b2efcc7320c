"""Timing on the card with CUDA events: device time of a call, the frame
time of a render, the forward and backward of the hard-path gradient, and
the fit step, each on one device or sharded over a mesh
(``parallel/mesh.py``), and the sharded frame over growing rank counts;
per-phase host timers (``PhaseTimer``) and a profiler trace of a block
(``trace_capture``)."""

from __future__ import annotations

import statistics
import time
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path

import torch

from raytracer_tpu_torch.core.types import Camera, Scene, resolve_device

__all__ = [
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


@contextmanager
def trace_capture(out_dir=None, *, device=None):
    """``torch.profiler`` over the block, written to ``out_dir/trace.json``
    (Chrome trace format: Perfetto or chrome://tracing). It records the
    host's ops, and the card's kernels when ``device`` (``None``: CUDA) is
    a CUDA device; the card is synchronized before the block ends.
    ``out_dir=None`` is a no-op, so a command-line flag can be passed
    straight through."""
    if not out_dir:
        yield
        return
    cuda = resolve_device(device).type == "cuda"
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(Path(out_dir) / "trace.json"))


class PhaseTimer:
    """Wall-time samples per named phase, and their averages (the frame
    loop's exit report)."""

    def __init__(self):
        self.samples: dict[str, list[float]] = defaultdict(list)

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples[name].append(time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        self.samples[name].append(seconds)

    def averages(self) -> dict[str, float]:
        return {k: sum(v) / len(v) for k, v in self.samples.items() if v}

    def report(self) -> str:
        """One line a phase: its average in ms and its sample count."""
        lines = [
            f"average {name} time: {avg * 1e3:.3f} ms  ({len(self.samples[name])} samples)"
            for name, avg in sorted(self.averages().items())
        ]
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
