"""The median host time inside one ``render`` call, from the call to its
return: the harness's own span around the program's entry point. Read in a
``--trace 1`` run, over the calls of the window's first, untraced share
(``harness.QUIET``), before the profiler starts."""

import statistics


def read(ctx):
    if ctx["kind"] != "render" or not ctx["calls"]:
        return None
    return statistics.median(ctx["calls"]) * 1e3
