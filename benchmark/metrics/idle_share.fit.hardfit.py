"""``idle_share.fit``, read in the hard fit: the same reader (``idle_share.fit.py``)."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("benchmark_metric_idle_share_fit",
                                               Path(__file__).with_name("idle_share.fit.py"))
_base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_base)
read = _base.read
