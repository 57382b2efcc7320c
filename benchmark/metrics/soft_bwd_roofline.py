"""The share of its roofline that the soft level backward kernel (a fit step) reach:
``work.soft_bwd``'s least time over their device time in the traced window."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("benchmark_metric_roofline",
                                               Path(__file__).with_name("_roofline.py"))
_roofline = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_roofline)


def read(ctx):
    return _roofline.share(ctx, "soft_bwd_roofline", "soft_bwd", "fit")
