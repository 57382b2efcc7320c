"""Command-line interface: render, bench, fit, view, configs.

Every subcommand that renders runs on CUDA unless ``--device cpu`` is
given (the kernels' plain PyTorch versions). Usage:

    python -m raytracer_tpu_torch.app.cli render --config c3-1080p-3bounce -o out.png
    python -m raytracer_tpu_torch.app.cli render --config c1-depth-pass -o depth.png
    python -m raytracer_tpu_torch.app.cli render --scene grid --n 64 --width 1280 \\
        --height 720 --depth 3 -o grid.png
    python -m raytracer_tpu_torch.app.cli bench --config c3-1080p-3bounce --fwd-bwd
    python -m raytracer_tpu_torch.app.cli fit --steps 600 -o fit_out/
    python -m raytracer_tpu_torch.app.cli view          # WASD/arrows + q, in-terminal
    python -m raytracer_tpu_torch.app.cli configs
    torchrun --nproc-per-node 2 -m raytracer_tpu_torch.app.cli render \\
        --config c5-4k-1024sphere --mesh 2,1 -o c5.png   # one rank a device

With ``--mesh`` (or a config's own mesh) ``render``, ``bench`` and ``fit``
shard over the ranks torchrun starts (``RenderConfig.build_mesh``); only
rank 0 writes files and prints.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from raytracer_tpu_torch.app.config import BASELINE_CONFIGS, RenderConfig, get_config

__all__ = ["main"]


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="raytracer_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    device_help = ("torch device to run on (default: cuda; 'cpu' runs the kernels' plain "
                   "PyTorch versions); before or after the subcommand")
    p.add_argument("--device", default=None, help=device_help)
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_scene_flags(sp):
        sp.add_argument("--config", choices=sorted(BASELINE_CONFIGS), default=None)
        sp.add_argument("--scene", choices=["demo", "sprint3", "grid", "random", "logo", "mixed"])
        sp.add_argument("--n", type=int, default=64, help="procedural sphere count")
        sp.add_argument("--width", type=int)
        sp.add_argument("--height", type=int)
        sp.add_argument("--depth", type=int, help="reflection bounces")
        sp.add_argument("--fold", choices=["auto", "jnp", "pallas", "pallas_flat"])
        sp.add_argument("--no-tonemap", action="store_true")
        sp.add_argument(
            "--mesh", default=None, metavar="PX,PRIM|auto|none",
            help="shard over a mesh of ranks (torchrun, one rank a device): 'auto' (every "
            "rank on the pixel axis; one rank renders alone), 'PX,PRIM' (explicit "
            "shape, PX*PRIM ranks), 'none' (override a config's mesh to one device)",
        )
        sp.add_argument("--device", default=argparse.SUPPRESS, help=device_help)

    r = sub.add_parser("render", help="render one frame to an image file")
    add_scene_flags(r)
    r.add_argument("-o", "--output", default="frame.png")
    r.add_argument("--depth-only", action="store_true")

    b = sub.add_parser("bench", help="rays/s + fwd/bwd benchmark (CUDA only)")
    add_scene_flags(b)
    b.add_argument("--iters", type=int, default=10)
    b.add_argument("--fwd-bwd", action="store_true", help="also time backward")
    b.add_argument(
        "--trace", default=None, metavar="DIR",
        help="write a torch.profiler trace of the timed frames to DIR/trace.json "
        "(open with Perfetto or chrome://tracing)",
    )

    f = sub.add_parser("fit", help="differentiable fit to a target image")
    add_scene_flags(f)
    f.add_argument("--steps", type=int, default=200)
    f.add_argument("--lr", type=float, default=2e-2)
    f.add_argument("--perturb", type=float, default=0.15)
    f.add_argument("--soft-tau", type=float, default=2e-3)
    f.add_argument("-o", "--output", default="fit_out")
    f.add_argument("--resume", default=None, help="checkpoint to resume from")

    v = sub.add_parser("view", help="interactive terminal viewer (WASD + q)")
    add_scene_flags(v)
    v.add_argument("--max-cols", type=int, default=100)
    v.add_argument("--frames", type=int, default=0, help="exit after N frames")
    v.add_argument("--log", default=None, help="write frame-time .log on exit")
    v.add_argument("--test-pattern", action="store_true",
                   help="show the reference's debug gradient instead of the scene")

    sub.add_parser("configs", help="list the BASELINE configurations")
    return p


def _config_from_args(args) -> RenderConfig:
    if args.config:
        cfg = get_config(args.config)
    else:
        scene = args.scene or "demo"
        cfg = RenderConfig(
            name=f"cli-{scene}",
            scene=scene,
            scene_args={"n": args.n} if scene in ("grid", "random") else {},
            width=640, height=480, depth=3,
        )
    for field in ("width", "height", "depth", "fold"):
        val = getattr(args, field, None)
        if val is not None:
            cfg = cfg.replace(**{field: val})
    if getattr(args, "no_tonemap", False):
        cfg = cfg.replace(tonemap=False)
    if getattr(args, "depth_only", False):
        cfg = cfg.replace(depth_only=True)
    if getattr(args, "mesh", None) is not None:
        m = args.mesh.strip().lower()
        if m == "none":
            cfg = cfg.replace(mesh=None)
        elif m == "auto":
            cfg = cfg.replace(mesh="auto")
        else:
            px, prim = (int(v) for v in m.split(","))
            cfg = cfg.replace(mesh=(px, prim))
    return cfg


def depth_image(depth_map: np.ndarray) -> np.ndarray:
    """A depth map as a grey ``[H, W, 3]`` image: near 1, far 0, misses 0."""
    finite = np.isfinite(depth_map)
    span = depth_map[finite].max() - depth_map[finite].min() if finite.any() else 1
    viz = np.where(
        finite, 1.0 - (depth_map - depth_map[finite].min()) / max(span, 1e-6), 0.0
    )
    return np.repeat(viz[..., None], 3, axis=-1)


def cmd_render(args) -> int:
    from raytracer_tpu_torch.io import save_image
    from raytracer_tpu_torch.parallel.hosts import is_lead
    from raytracer_tpu_torch.parallel.render import render_sharded
    from raytracer_tpu_torch.render.integrator import render, render_depth

    cfg = _config_from_args(args)
    mesh = cfg.build_mesh(device=args.device)
    scene, camera = cfg.build_scene(device=args.device), cfg.build_camera(device=args.device)
    t0 = time.perf_counter()
    with torch.no_grad():
        if cfg.depth_only:
            depth_map = render_depth(scene, camera, cfg.width, cfg.height, device=args.device)
            img = depth_image(depth_map.cpu().numpy())
        elif mesh is not None:
            img = render_sharded(scene, camera, cfg.width, cfg.height, mesh=mesh,
                                 depth=cfg.depth, tonemap=cfg.tonemap,
                                 fold=cfg.fold).cpu().numpy()
        else:
            img = render(scene, camera, cfg.width, cfg.height, depth=cfg.depth,
                         tonemap=cfg.tonemap, fold=cfg.fold, device=args.device).cpu().numpy()
    if not is_lead():
        return 0
    out = save_image(args.output, img)
    mesh_note = f" mesh={'x'.join(str(s) for s in mesh.devices.shape)}" if mesh else ""
    print(f"{cfg.name}: {cfg.width}x{cfg.height} depth={cfg.depth}{mesh_note} -> {out}  "
          f"({time.perf_counter() - t0:.2f}s inc. kernel build)")
    return 0


def cmd_bench(args) -> int:
    from raytracer_tpu_torch.utils.profiler import (
        benchmark_forward_backward,
        benchmark_render,
        need_cuda,
        trace_capture,
    )

    from raytracer_tpu_torch.parallel.hosts import is_lead

    need_cuda(args.device)  # the timers measure only on the card
    cfg = _config_from_args(args)
    mesh = cfg.build_mesh(device=args.device)
    scene, camera = cfg.build_scene(device=args.device), cfg.build_camera(device=args.device)
    with trace_capture(args.trace if is_lead() else None, device=args.device):
        res = benchmark_render(
            scene, camera, cfg.width, cfg.height,
            depth=cfg.depth, iters=args.iters, fold=cfg.fold, tonemap=cfg.tonemap, mesh=mesh,
        )
        res["config"] = cfg.name
        if args.fwd_bwd:
            # At the config's own depth, comparable with the forward.
            res.update(
                benchmark_forward_backward(
                    scene, camera, cfg.width, cfg.height, depth=cfg.depth, fold=cfg.fold,
                    mesh=mesh,
                )
            )
    if not is_lead():
        return 0
    if args.trace:
        res["trace_dir"] = args.trace
    print(json.dumps(res))
    return 0


def cmd_fit(args) -> int:
    from raytracer_tpu_torch.app.fit import run_fit

    if args.config is None and args.scene is None:
        args.config = "c4-fit-64sphere"  # the BASELINE fit workload
    cfg = _config_from_args(args)
    if args.config is None and args.depth is None:
        # Ad-hoc fits default to one differentiable bounce.
        cfg = cfg.replace(depth=1)
    return run_fit(
        cfg,
        steps=args.steps,
        lr=args.lr,
        perturb=args.perturb,
        soft_tau=args.soft_tau,
        out_dir=Path(args.output),
        resume=args.resume,
        device=args.device,
    )


def cmd_view(args) -> int:
    from raytracer_tpu_torch.app.viewer import run_viewer

    cfg = _config_from_args(args)
    if cfg.build_mesh(device=args.device) is not None:
        raise ValueError("view renders on one device; run it without a mesh (--mesh none)")
    if args.width is None:
        cfg = cfg.replace(width=256, height=192, depth=min(cfg.depth, 3))
    return run_viewer(cfg, max_cols=args.max_cols, max_frames=args.frames,
                      log_path=args.log, test_pattern=args.test_pattern, device=args.device)


def cmd_configs(_args) -> int:
    for name, cfg in BASELINE_CONFIGS.items():
        print(
            f"{name:20s} {cfg.scene:8s} {cfg.width}x{cfg.height} "
            f"depth={cfg.depth} fit={cfg.fit} depth_only={cfg.depth_only}"
        )
    return 0


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    return {
        "render": cmd_render,
        "bench": cmd_bench,
        "fit": cmd_fit,
        "view": cmd_view,
        "configs": cmd_configs,
    }[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
