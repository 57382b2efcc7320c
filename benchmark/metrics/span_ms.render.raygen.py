"""Milliseconds a frame in ``rt.raygen``: the camera rays of each row chunk
(``ops/trace.py`` ``raygen_tile``), from the program's span registry."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("benchmark_metric_spans",
                                               Path(__file__).with_name("_spans.py"))
_spans = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_spans)


def read(ctx):
    return _spans.span_ms(ctx, "render", "rt.raygen")
