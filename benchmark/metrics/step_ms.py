"""The window, from its start to the synchronise that ends it, over the fit
steps it completed."""


def read(ctx):
    if ctx["kind"] != "fit" or not ctx["steps"]:
        return None
    return ctx["window_s"] / ctx["steps"] * 1e3
