"""The shared arithmetic of the ``*_roofline`` readers: the least time of
the function's work (``work.py``, counted on the traced run's inputs by the
reference) over the device time of the kernels that compute it in the
traced window. Which kernels compute a function is data: every
``<metric>.kernels*.json`` beside the reader lists name fragments, and a
kernel whose name holds one of them counts."""

import json
from pathlib import Path


def kernel_names(bench_dir, metric: str) -> list:
    names = []
    for path in sorted(Path(bench_dir, "metrics").glob(f"{metric}.kernels*.json")):
        names += json.loads(path.read_text())["kernels"]
    return names


def share(ctx, metric: str, work_key: str, kind: str):
    """Percent of the roofline, or None where there is nothing to read."""
    tr, w = ctx["trace"], ctx["work"].get(work_key)
    if ctx["kind"] != kind or tr is None or w is None or not ctx["traced"]:
        return None
    frags = kernel_names(ctx["bench_dir"], metric)
    busy = sum(s for name, s in tr["kernels"].items() if any(f in name for f in frags))
    if busy <= 0:
        return None
    return 100.0 * w["s"] * ctx["traced"] / busy
