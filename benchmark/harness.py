"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``: a configuration
(``configs/<config>.json``), a traffic mix (``traffic/<traffic>.json``) and
its limits (``workloads/<cell>.json``). Every metric is read by its own
module, ``metrics/<metric>.py``, from the run's observations; a metric
named in ``BENCHMARK.json`` is reported in the cells that list it. So a
later cell, configuration or metric is a file added, not a file edited.

Two kinds of traffic run:

* ``render``: a closed loop of one client. Each frame is one ``render``
  call at the next camera of the viewer's walk, waited for before the next
  is sent. The window's first frame and frames drawn from the seed among
  the others it renders are kept and, after the window, compared with the
  reference's frames of the same cameras.
* ``fit``: ``make_fit_step``'s steps issued back to back, as the fit app
  issues them between its logs; the parameters restart from a fresh draw
  every ``restart_every`` steps. Set-up drives the one fit object through
  its first steps; the reference follows them from the same start, and
  the step losses, the parameters' change and the first gradient (from
  Adam's first moment) are compared.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import random
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import compare, devtrace, inputs, work
from benchmark.reference import common, hard, soft

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
QUIET = 0.35  # the untraced share at the start of a --trace 1 window
TRACE_S = 4.0  # then the seconds whose device activity is traced
NAME_S = 1.5  # then the seconds whose host ops are traced too, to name the idle gaps
FORBIDDEN = ("jax", "jaxlib", "flax", "raytracer_tpu")  # top-level module names


@dataclasses.dataclass
class Spec:
    """Everything one cell names, loaded from its files."""

    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    bench_dir: Path


def _listed(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_spec(cell: str, root: Path = ROOT, bench_dir: Path = BENCH_DIR) -> Spec:
    """The cell ``cell`` of ``root/BENCHMARK.json`` with its files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    rows = [w for w in bench["workloads"] if w["name"] == cell]
    if not rows:
        raise KeyError(f"no cell {cell!r} in BENCHMARK.json")
    w = rows[0]

    def load(folder, name):
        return json.loads((bench_dir / folder / f"{name}.json").read_text())

    return Spec(
        name=cell,
        config=load("configs", w["config"]),
        traffic=load("traffic", w["traffic"]),
        limits=load("workloads", cell)["limits"],
        end_to_end=[m for m in bench["end_to_end"] if _listed(m, cell)],
        per_layer=[m for m in bench["per_layer"] if _listed(m, cell)],
        bench_dir=bench_dir,
    )


def read_metric(bench_dir: Path, name: str, ctx: dict):
    """The value of metric ``name`` from ``metrics/<name>.py``'s ``read``,
    or None where it finds nothing to read."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


class Program:
    """The system under test, ``raytracer_tpu_torch``, as the harness
    drives it: the scene and camera from the benchmark's arrays, a frame,
    and the fit step."""

    def __init__(self, device):
        import raytracer_tpu_torch as rt

        self.rt = rt
        self.device = device

    def scene(self, arrays: dict):
        return self.rt.Scene.from_numpy(arrays, device=self.device)

    def camera(self, cam: dict):
        return self.rt.Camera.from_numpy(cam, device=self.device)

    def render(self, scene, camera, t: dict):
        return self.rt.render(scene, camera, t["width"], t["height"], depth=t["depth"],
                              tonemap=t["tonemap"], fold=t["fold"], device=self.device)

    def fit_step(self, t: dict):
        """``(init_fn, step_fn)`` of ``make_fit_step`` for the traffic."""
        kw = {}
        if t["soft"]:
            kw = dict(soft=True, soft_tau=t["tau"], soft_tau_z=t["tau_z"])
        return self.rt.make_fit_step(t["width"], t["height"], depth=t["depth"],
                                     learning_rate=t["learning_rate"], tonemap=t["tonemap"],
                                     device=self.device, **kw)

    def start(self, truth, params: dict):
        return self.rt.merge_params(truth, params)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _log(*parts):
    print("[benchmark]", *parts, file=sys.stderr, flush=True)


class _Window:
    """The measured loop's clock and, with ``trace``, the profiler over a
    part of it. A traced window runs untraced for its first ``QUIET``
    share (the calls that the host times and latencies are read from),
    then traces the device's activity alone for ``TRACE_S`` seconds (the
    busy time and the kernels), then the host's ops as well for ``NAME_S``
    seconds (which only name the idle gaps); it runs on past ``seconds``
    until both traced parts are done. The traces are read after the window
    has closed."""

    def __init__(self, device, seconds: float, trace: bool):
        self.device, self.seconds = device, seconds
        self.phases = []
        if trace:
            dev = [torch.profiler.ProfilerActivity.CUDA if device.type == "cuda"
                   else torch.profiler.ProfilerActivity.CPU]
            both = [torch.profiler.ProfilerActivity.CPU, *dev[:device.type == "cuda"]]
            # (name, activities, earliest start, length); a phase starts once
            # the one before it has ended.
            self.phases = [("device", dev, QUIET * seconds, TRACE_S),
                           ("host", both, 0.0, NAME_S)]
            with torch.profiler.profile(activities=both):  # the profiler's own start-up, in set-up
                _sync(device)
        self.prof = None
        self.phase = "quiet"
        self.done = {}  # phase: its finished profiler
        self.traced = 0  # calls inside the device phase

    def __enter__(self):
        _sync(self.device)
        self.t0 = time.perf_counter()
        return self

    def running(self) -> bool:
        now = time.perf_counter() - self.t0
        if self.prof is not None and now >= self.until:
            self._stop_phase()
        if self.prof is None and self.phases and now >= self.phases[0][2]:
            name, acts, _, length = self.phases.pop(0)
            _sync(self.device)
            self.phase, self.prof = name, torch.profiler.profile(activities=acts)
            self.prof.__enter__()
            self.span = torch.profiler.record_function(devtrace.WINDOW)
            self.span.__enter__()
            # Each phase lasts its length from when its profiler is running.
            self.until = time.perf_counter() - self.t0 + length
        now = time.perf_counter() - self.t0
        return now < self.seconds or self.prof is not None or bool(self.phases)

    def count(self):
        if self.phase == "device":
            self.traced += 1

    def quiet(self) -> bool:
        """Whether no profiler runs now: only such calls are timed."""
        return self.phase == "quiet"

    def _stop_phase(self):
        _sync(self.device)
        self.span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.done[self.phase] = self.prof
        self.prof, self.phase = None, "quiet"

    def __exit__(self, *exc):
        _sync(self.device)
        self.t1 = time.perf_counter()
        if self.prof is not None:
            self._stop_phase()
        return False

    @property
    def summary(self) -> dict | None:
        """The device phase's ``devtrace.summary``, its idle gaps named from
        the host phase; None for an untraced window."""
        if "device" not in self.done:
            return None
        out = devtrace.summary(devtrace.events(self.done["device"]))
        if out is not None and "host" in self.done:
            host = devtrace.summary(devtrace.events(self.done["host"]))
            if host is not None:
                out["idle_gaps"] = host["idle_gaps"]
        return out

    @property
    def elapsed(self) -> float:
        return self.t1 - self.t0


def _run_render(spec: Spec, seed: int, seconds: float, trace: bool, device, program) -> dict:
    t, cfg = spec.traffic, spec.config
    arrays = inputs.scene_arrays(cfg)
    walk = inputs.camera_walk(cfg["camera"], t["walk"])
    vfov = cfg["camera"]["vfov"]
    first = seed % len(walk)
    scene = program.scene(arrays)
    cams = [program.camera(inputs.camera_at(walk, k, vfov)) for k in range(len(walk))]
    sample = _FrameSample(t["sample_frames"], seed)
    img = program.render(scene, cams[first], t)  # warm-up: builds and loads the kernels
    _sync(device)
    del img
    obs = {"latency": [], "calls": []}
    with _Window(device, seconds, trace) as win:
        setup_end = time.perf_counter()
        k = 0
        while win.running():
            cam = cams[(first + k) % len(walk)]
            a = time.perf_counter()
            img = program.render(scene, cam, t)
            b = time.perf_counter()
            _sync(device)
            if win.quiet():
                obs["latency"].append(time.perf_counter() - a)
                obs["calls"].append(b - a)
            win.count()
            sample.offer(k, img)
            k += 1
    obs.update(frames=k, window=win, setup_end=setup_end, arrays=arrays, kept=sample.kept,
               cams={k: inputs.camera_at(walk, first + k, vfov) for k in sample.kept})
    return obs


class _FrameSample:
    """The frames a render run compares: the window's first, and ``n - 1``
    drawn from the seed among all the others it renders (a reservoir, so
    every frame rendered has the same chance whatever the window's length,
    and only the frames kept are held)."""

    def __init__(self, n: int, seed: int):
        self.n, self.rng, self.kept, self.seen = n, random.Random(seed), {}, 0

    def offer(self, k: int, img):
        if k == 0 or len(self.kept) < self.n:
            self.kept[k] = img
            self.seen += k > 0
            return
        self.seen += 1
        slot = self.rng.randrange(self.seen)
        if slot < self.n - 1:
            del self.kept[sorted(self.kept)[1 + slot]]
            self.kept[k] = img


def _adam(params: dict, grads: dict, state: dict, lr: float, b1=0.9, b2=0.999, eps=1e-8):
    """One Adam step in place, as ``torch.optim.Adam`` takes it."""
    state["t"] = state.get("t", 0) + 1
    bc1, bc2 = 1 - b1 ** state["t"], 1 - b2 ** state["t"]
    with torch.no_grad():
        for k, p in params.items():
            g = grads[k]
            m = state.setdefault("m_" + k, torch.zeros_like(p))
            v = state.setdefault("v_" + k, torch.zeros_like(p))
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            p.addcdiv_(m, v.sqrt() / math.sqrt(bc2) + eps, value=-lr / bc1)


def reference_steps(t: dict, arrays: dict, cam: dict, target, start: dict, device,
                    dtype=torch.float32, stats: list | None = None,
                    rows: int | None = None) -> dict:
    """The reference's first steps of the fit from ``start``: each step's
    loss, the first step's gradient, the parameters' change. ``rows``
    takes each loss over the frame's first rows only (a planted fault)."""
    scene = common.to_tensors(arrays, device, dtype)
    rcam = common.to_tensors(cam, device, dtype)
    params = {k: v.detach().to(dtype).clone().requires_grad_(True) for k, v in start.items()}
    losses, state, first = [], {}, None
    for i in range(t["first_steps"]):
        kw = dict(tone=t["tonemap"], stats=stats if i == 0 else None, rows=rows)
        if t["soft"]:
            loss, grads = soft.loss_and_grads(scene, params, rcam, t["width"], t["height"],
                                              t["depth"], target.to(dtype), tau=t["tau"],
                                              tau_z=t["tau_z"], **kw)
        else:
            loss, grads = hard.loss_and_grads(scene, params, rcam, t["width"], t["height"],
                                              t["depth"], target.to(dtype), **kw)
        losses.append(float(loss))
        if first is None:
            first = {k: g.detach().float().clone() for k, g in grads.items()}
        _adam(params, grads, state, t["learning_rate"])
    change = {k: (p.detach().float() - start[k].float()) for k, p in params.items()}
    return {"losses": losses, "grad": first, "change": change}


def _first_gradient(opt: torch.optim.Optimizer, leaves: dict) -> dict:
    """The gradient the optimizer got at its first step, from Adam's first
    moment ``(1 - beta1) g`` (zeros for a leaf it holds no moment of)."""
    b1 = opt.param_groups[0]["betas"][0]
    out = {}
    for k, p in leaves.items():
        m = opt.state.get(p, {}).get("exp_avg")
        out[k] = torch.zeros_like(p, dtype=torch.float32) if m is None else m.float() / (1 - b1)
    return out


def _fit_target(t: dict, arrays: dict, cam: dict, device):
    """The fit's target: the reference's hard frame of the true scene as an
    image, each channel clipped to [0, 1]. A pixel that is not finite (a
    mirror chain that grazes sphere after sphere can overflow) is black."""
    scene = common.to_tensors(arrays, device)
    img = hard.render(scene, common.to_tensors(cam, device), t["width"], t["height"],
                      t["depth"], tone=t["tonemap"])
    img = torch.where(torch.isfinite(img).all(dim=-1, keepdim=True), img, 0.0)
    return img.clamp_(0.0, 1.0)


def _run_fit(spec: Spec, seed: int, seconds: float, trace: bool, device, program) -> dict:
    t, cfg = spec.traffic, spec.config
    arrays = inputs.scene_arrays(cfg)
    cam = {k: np.asarray(v, np.float32) for k, v in cfg["camera"].items()}
    truth = program.scene(arrays)
    camera = program.camera(cam)
    target = _fit_target(t, arrays, cam, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    g = inputs.seeded_generator(seed, device)
    start = inputs.start_draw(arrays, t["perturb"], g, device)
    init_fn, step_fn = program.fit_step(t)
    state = init_fn(program.start(truth, start))
    leaves = dict(state.params)
    losses, grad = [], None
    for i in range(t["first_steps"]):  # the fit's first steps: warm-up, and the check's readings
        state, loss = step_fn(state, truth, camera, target)
        losses.append(float(loss))
        if i == 0:
            grad = _first_gradient(state.optimizer, leaves)
    got = {"losses": losses, "grad": grad,
           "change": {k: p.detach().float() - start[k].float() for k, p in leaves.items()}}
    obs = {"calls": [], "steps": 0}
    with _Window(device, seconds, trace) as win:
        setup_end = time.perf_counter()
        while win.running():
            if state.step % t["restart_every"] == 0:
                fresh = inputs.start_draw(arrays, t["perturb"], g, device)
                with torch.no_grad():
                    for k, p in leaves.items():
                        p.copy_(fresh[k])
                state.optimizer.state.clear()
            a = time.perf_counter()
            state, _ = step_fn(state, truth, camera, target)
            if win.quiet():
                obs["calls"].append(time.perf_counter() - a)
            win.count()
            obs["steps"] += 1
    obs.update(window=win, setup_end=setup_end, arrays=arrays, cam=cam, target=target,
               start=start, got=got)
    return obs


def _card(device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                              f"--id={device.index or 0}"], capture_output=True, text=True,
                             timeout=20)
        out["power_limit"] = smi.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out["power_limit"] = "not read"
    return out


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(spec: Spec, seed: int, seconds: float, trace: bool, device, t_start: float,
             program=None) -> dict:
    """One run: the result's dict (``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, with ``trace`` ``breakdown``, and ``checks``),
    and ``readings``: every number worked out against the reference, also
    those no limit names."""
    device = torch.device(device)
    common.strict_float32()
    program = program or Program(device)
    kind = spec.traffic["kind"]
    runner = {"render": _run_render, "fit": _run_fit}[kind]
    obs = runner(spec, seed, seconds, trace, device, program)
    win = obs["window"]
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    summary = win.summary
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules of JAX or the JAX package are loaded: {found}")
    ctx = {"kind": kind, "traffic": spec.traffic, "counts": work.counts_of(obs["arrays"]),
           "setup_s": obs["setup_end"] - t_start, "window_s": win.elapsed,
           "calls": obs["calls"], "trace": summary, "traced": win.traced,
           "bench_dir": spec.bench_dir, "work": {}}
    t = spec.traffic
    a = time.perf_counter()
    if kind == "render":
        ctx.update(frames=obs["frames"], latency=obs["latency"], rays=t["width"] * t["height"])
        attempted = obs["frames"]
        kept = obs.pop("kept")
        values, failed = {"frames_not_compared": t["sample_frames"] - len(kept)}, 0
        scene = common.to_tensors(obs["arrays"], device)
        for k in sorted(kept):
            # The first frame compared also counts the work of a frame.
            stats = [{} for _ in range(t["depth"] + 1)] if "level_fwd" not in ctx["work"] else None
            ref = hard.render(scene, common.to_tensors(obs["cams"][k], device), t["width"],
                              t["height"], t["depth"], tone=t["tonemap"], stats=stats)
            share = compare.pixel_share(kept.pop(k), ref, spec.limits["pixel_tol"])
            del ref
            failed += share > spec.limits["frame_bad_share"]
            values["frame_bad_share"] = max(values.get("frame_bad_share", 0.0), share)
            if stats is not None:
                ctx["work"]["level_fwd"] = work.level_fwd(ctx["counts"], stats, ctx["rays"])
        checks = compare.judged(values, spec.limits)
    else:
        ctx.update(steps=obs["steps"])
        attempted = obs["steps"] + t["first_steps"]
        levels = [{} for _ in range(t["depth"] + 1)]
        want = reference_steps(t, obs["arrays"], obs["cam"], obs["target"], obs["start"],
                               device, stats=levels)
        for side, r in (("program", obs["got"]), ("reference", want)):
            norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in r["grad"].items()}
            _log(f"{side}: step losses {r['losses']}, first gradient norms {norms}")
        values = compare.fit_checks(obs["got"], want, spec.limits["grad_tol"])
        _log("readings:", json.dumps(values))
        checks = compare.judged(values, spec.limits)
        failed = 0 if compare.passes(checks) else 1
        if t["soft"]:
            ctx["work"].update(soft_fwd=work.soft_fwd(ctx["counts"], levels),
                               soft_bwd=work.soft_bwd(ctx["counts"], levels))
    _log(f"reference and comparison: {time.perf_counter() - a:.1f} s")
    metrics = {}
    for m in (spec.per_layer if trace else spec.end_to_end):
        v = read_metric(spec.bench_dir, m["name"], ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = dict(_card(device), memory_peak_bytes=int(peak))
    out = {"correct": compare.passes(checks), "attempted": attempted, "failed": int(failed),
           "metrics": metrics, "device": dev}
    if trace and summary is not None:
        dev.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        out["breakdown"] = {k: summary[k] for k in ("device_ops", "idle_gaps")}
    out["readings"] = values
    out["checks"] = checks
    return out
