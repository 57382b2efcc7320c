"""The sphere chunks a lane of ``soft_level_bwd`` reaches, over a fit step:
the (lane, chunk) pairs whose exact gate passes over the lanes launched
(the program's ``soft_bwd.lane_chunks`` and ``soft_bwd.lanes``, counted in
the kernel), the median a step."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("benchmark_metric_spans",
                                               Path(__file__).with_name("_spans.py"))
_spans = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_spans)


def read(ctx):
    return _spans.counters(ctx, "fit", ("soft_bwd.lane_chunks", "soft_bwd.lanes"),
                           lambda pairs, lanes: pairs / lanes)
