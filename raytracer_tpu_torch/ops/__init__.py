"""Ray generation, the closest-hit API, the bounce loop and its CUDA
kernels, and the tone map."""

from raytracer_tpu_torch.ops.trace import (
    background_soa,
    closest_hit_soa,
    fold_closest,
    resolve_fold_fn,
    shade_soa,
    trace_soa,
)

__all__ = [
    "background_soa",
    "closest_hit_soa",
    "fold_closest",
    "resolve_fold_fn",
    "shade_soa",
    "trace_soa",
]
