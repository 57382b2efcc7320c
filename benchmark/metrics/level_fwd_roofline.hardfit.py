"""``level_fwd_roofline`` read in the hard fit, which reports ``step_ms``: the per-level
chain's forward kernels (``level_fwd_roofline.kernels*.json``) against ``work.level_fwd``,
a fit step's forward."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("benchmark_metric_roofline",
                                               Path(__file__).with_name("_roofline.py"))
_roofline = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_roofline)


def read(ctx):
    return _roofline.share(ctx, "level_fwd_roofline", "level_fwd", "fit")
