"""Milliseconds a fit step in ``rt.soft_pack``: the soft tables and gates
(``diff/soft.py`` ``trace_soft``), from the program's span registry."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("benchmark_metric_spans",
                                               Path(__file__).with_name("_spans.py"))
_spans = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_spans)


def read(ctx):
    return _spans.span_ms(ctx, "fit", "rt.soft_pack")
