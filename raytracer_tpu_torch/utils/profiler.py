"""Timing on the card with CUDA events: device time of a call, and the
frame time of a render."""

from __future__ import annotations

import statistics

import torch

from raytracer_tpu_torch.core.types import Camera, Scene

__all__ = ["cuda_time_ms", "benchmark_render"]

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
