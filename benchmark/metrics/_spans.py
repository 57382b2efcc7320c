"""The shared reading of the program's span registry
(``raytracer_tpu_torch.utils.profiler``): its requests recorded in the
traced window (the device phase and the host phase, where a
``torch.profiler`` session runs), and per-request medians of a span's
summed milliseconds or of a counter. A render request is one ``render``
call (``rt.render``), a fit request one step (``rt.fit_step``). Every
reader returns None for the other kind of traffic, where nothing was
recorded, and where the program has no registry."""

import statistics

REQUEST = {"render": "rt.render", "fit": "rt.fit_step"}


def _registry():
    """The program's registry module, or None where it has none."""
    try:
        from raytracer_tpu_torch.utils import profiler
    except ImportError:
        return None
    return profiler if hasattr(profiler, "snapshot") else None


def requests(ctx, kind: str):
    """The window's recorded requests of ``kind``, or None."""
    reg = _registry() if ctx["kind"] == kind else None
    if reg is None:
        return None
    return [r for r in reg.snapshot()["requests"] if r["name"] == REQUEST[kind]] or None


def median(ctx, kind: str, value):
    """The median over the window's requests of ``kind`` of ``value(r)``,
    leaving out the requests where it is None; None if none is left."""
    vals = [v for v in map(value, requests(ctx, kind) or []) if v is not None]
    return statistics.median(vals) if vals else None


def span_ms(ctx, kind: str, name: str):
    """Milliseconds of the spans named ``name`` a request (every one of
    them in it: its row chunks, levels or updates), the median; None where
    no request has one."""
    def total(r):
        ns = _registry().span_totals_ns(r).get(name)
        return None if ns is None else ns / 1e6

    return median(ctx, kind, total)


def self_ms(ctx, kind: str):
    """The request's own span's self time (its duration less what its
    child spans cover), the median."""
    return median(ctx, kind, lambda r: _registry().self_ns(r, r["name"]) / 1e6)


def counter(ctx, kind: str, name: str):
    """The counter ``name`` a request, the median."""
    return median(ctx, kind, lambda r: r["counters"].get(name))


def counters(ctx, kind: str, names, fn):
    """``fn`` of the counters ``names`` a request (where it has them all),
    the median."""
    def value(r):
        c = r["counters"]
        return fn(*(c[n] for n in names)) if all(c.get(n) for n in names) else None

    return median(ctx, kind, value)
