"""The share of the traced window in which nothing ran on the card: one
less the union of the device's kernels, copies and fills over the window
(torch.profiler)."""


def read(ctx):
    tr = ctx["trace"]
    if ctx["kind"] != "render" or tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
