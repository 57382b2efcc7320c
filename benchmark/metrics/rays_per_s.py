"""Primary rays of every frame completed in the window, over the window, in
millions a second."""


def read(ctx):
    if ctx["kind"] != "render" or not ctx["frames"]:
        return None
    return ctx["frames"] * ctx["rays"] / ctx["window_s"] / 1e6
