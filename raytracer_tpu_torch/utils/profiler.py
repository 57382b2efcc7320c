"""Timing on the card with CUDA events: device time of a call, the frame
time of a render, the forward and backward of the hard-path gradient, and
the fit step."""

from __future__ import annotations

import statistics

import torch

from raytracer_tpu_torch.core.types import Camera, Scene

__all__ = [
    "cuda_time_ms",
    "benchmark_render",
    "benchmark_forward_backward",
    "benchmark_fit_step",
]

# Device cycles of the spin queued before each timed call (~0.5 ms at the
# H100's boost clock): long enough for the host to enqueue the call behind
# it, so the events bracket device work and not the host's enqueue.
_SPIN_CYCLES = 1_000_000


def _need_cuda():
    if not torch.cuda.is_available():
        raise RuntimeError("timing on the card needs a CUDA device; none is available")


def cuda_time_ms(fn, *, iters: int = 10, warmup: int = 2) -> list[float]:
    """Device milliseconds of each of ``iters`` calls of ``fn()`` on the
    current stream, from a pair of CUDA events around each call, after
    ``warmup`` untimed calls."""
    _need_cuda()
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
    tonemap: bool = True,
) -> dict:
    """Forward-render throughput on the card: the median over ``iters``
    frames of the CUDA-event time from just before the ``render`` call to
    the end of its last device op, and primary rays/s at that frame time.
    Nothing is queued ahead of a frame, so host work that holds the device
    back counts in the frame."""
    from raytracer_tpu_torch.render.integrator import render

    _need_cuda()
    scene, camera = scene.to("cuda"), camera.to("cuda")
    render(scene, camera, width, height, depth=depth, tonemap=tonemap)
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        render(scene, camera, width, height, depth=depth, tonemap=tonemap)
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
        "device": torch.cuda.get_device_name(0),
    }


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
    """
    from raytracer_tpu_torch.parallel.train import default_params, merge_params
    from raytracer_tpu_torch.render.integrator import render

    _need_cuda()
    scene, camera = scene.to("cuda"), camera.to("cuda")
    with torch.no_grad():
        target = render(scene, camera, width, height, depth=depth)
    fixed = default_params(scene)
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in fixed.items()}

    def loss(params):
        img = render(merge_params(scene, params), camera, width, height, depth=depth)
        return torch.mean((img - target) ** 2)

    def forward():
        with torch.no_grad():
            loss(fixed)

    def forward_train():
        loss(leaves)

    def forward_backward():
        torch.autograd.grad(loss(leaves), list(leaves.values()))

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
) -> dict:
    """Time of one ``make_fit_step`` step (render with gradients, the soft
    ``render_soft`` with ``soft``, backward, optimizer update; ``optimizer``
    as ``make_fit_step`` takes it) on the
    card: the median over ``iters`` steps of the CUDA event time from just
    before the step, with nothing queued ahead, to the end of its last
    device op, fitting ``scene`` to a black image."""
    from raytracer_tpu_torch.parallel.train import make_fit_step

    _need_cuda()
    scene, camera = scene.to("cuda"), camera.to("cuda")
    target = torch.zeros((height, width, 3), dtype=torch.float32, device="cuda")
    init_fn, step_fn = make_fit_step(width, height, depth=depth, soft=soft, optimizer=optimizer)
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
    }
