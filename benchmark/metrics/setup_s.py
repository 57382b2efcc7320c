"""Set-up: from the start of the process to the start of the window
(imports, the card's context, the inputs, the kernels' builds and loads,
the warm-up frame or the fit's first steps)."""


def read(ctx):
    return ctx["setup_s"]
