"""The 95th percentile (nearest rank), over the frames named below, of the
time from the ``render`` call to its image being ready on the card. The card is
idle most of a frame (``idle_share.render``), so the host paces the frames
and this tail swings with the host's load: it stands beside ``rays_per_s``
and moves it, without a bound of its own. Read in a ``--trace 1`` run, over
the frames of the window's first, untraced share (``harness.QUIET``): the
frames rendered while the profiler runs are left out."""

import math


def read(ctx):
    if ctx["kind"] != "render" or not ctx["latency"]:
        return None
    lat = sorted(ctx["latency"])
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3
