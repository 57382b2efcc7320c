"""``soft_fwd_roofline``, read in the grid-1024 soft fit, which reports ``step_ms.grid1024``:
the same reader (``soft_fwd_roofline.py``) and its kernels (``soft_fwd_roofline.kernels*.json``)."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("benchmark_metric_soft_fwd_roofline",
                                               Path(__file__).with_name("soft_fwd_roofline.py"))
_base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_base)
read = _base.read
