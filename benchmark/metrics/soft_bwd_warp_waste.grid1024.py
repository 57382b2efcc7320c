"""How many (lane, chunk) pairs a warp of ``soft_level_bwd`` walks for each
one its lanes need, over a fit step: 32 times the chunks the warps walk
(the union of their lanes' masks) over the (lane, chunk) pairs whose
exact gate passes (the program's ``soft_bwd.warp_chunks`` and
``soft_bwd.lane_chunks``, counted in the kernel). 1 where every lane of a
warp needs every chunk the warp enters; the median a step."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("benchmark_metric_spans",
                                               Path(__file__).with_name("_spans.py"))
_spans = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_spans)


def read(ctx):
    return _spans.counters(ctx, "fit", ("soft_bwd.warp_chunks", "soft_bwd.lane_chunks"),
                           lambda warp, lane: 32.0 * warp / lane)
