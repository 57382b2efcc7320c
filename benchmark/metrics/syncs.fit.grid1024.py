"""``syncs.fit``, read in the grid-1024 soft fit, which reports ``step_ms.grid1024``:
the same reader (``syncs.fit.py``)."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("benchmark_metric_syncs_fit",
                                               Path(__file__).with_name("syncs.fit.py"))
_base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_base)
read = _base.read
