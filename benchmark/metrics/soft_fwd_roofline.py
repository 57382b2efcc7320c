"""The share of its roofline that the soft level kernel (a fit step) reach:
``work.soft_fwd``'s least time over their device time in the traced window."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("benchmark_metric_roofline",
                                               Path(__file__).with_name("_roofline.py"))
_roofline = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_roofline)


def read(ctx):
    return _roofline.share(ctx, "soft_fwd_roofline", "soft_fwd", "fit")
