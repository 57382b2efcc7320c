"""Distribution over ranks: the mesh, sharded rendering, the meshed fit.

The reference renderer splits scanlines over OpenMP threads on one CPU and
has no communication backend. The port's counterpart, as the JAX package's,
is a 2-D mesh, here of ``torch.distributed`` ranks (one process and one
device a rank):

* axis ``'px'``: data parallelism over pixel rows; rays never communicate,
  so this axis needs no collective but the final gather of the tiles.
* axis ``'prim'``: optional sharding of the sphere axis; each rank folds its
  slice of the spheres and the per-shard closest hits combine every bounce
  (an all-gather of ``t`` and a masked sum of the winner's record).

Scene parameters are held whole on every rank; the meshed fit step sums
the parameter gradients over the mesh after its backward
(``parallel/comm.py`` holds every collective).
"""

from raytracer_tpu_torch.parallel.hosts import (
    initialize_distributed,
    is_lead,
    is_multi_host,
    slice_mesh,
)
from raytracer_tpu_torch.parallel.mesh import Mesh, make_mesh, pad_scene_spheres, scene_pspecs
from raytracer_tpu_torch.parallel.render import render_sharded
from raytracer_tpu_torch.parallel.train import FitState, make_fit_step

__all__ = [
    "initialize_distributed",
    "is_multi_host",
    "is_lead",
    "slice_mesh",
    "Mesh",
    "make_mesh",
    "pad_scene_spheres",
    "scene_pspecs",
    "render_sharded",
    "FitState",
    "make_fit_step",
]
