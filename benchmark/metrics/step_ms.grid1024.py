"""``step_ms``, read in the grid-1024 soft fit, which reports ``step_ms.grid1024``:
the same reader (``step_ms.py``)."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("benchmark_metric_step_ms",
                                               Path(__file__).with_name("step_ms.py"))
_base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_base)
read = _base.read
