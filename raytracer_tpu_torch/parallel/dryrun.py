"""Multi-rank runs in processes on one host: a launcher and a dry run.

``spawn`` starts ``world`` ranks with ``torch.multiprocessing`` (the spawn
start method), each in a ``tcp://127.0.0.1`` process group of its own
making, runs ``fn(*args)`` on every rank and returns what each returned.
The function must be importable by name from a module (children unpickle
it by its import path). A rank that raises, or a run that outlasts
``timeout_s``, ends every rank and raises here.

``dryrun_multichip(n)`` is the counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``: on ``n`` ranks, one CUDA device each
(NCCL) unless the caller asks for the CPU, it runs the sharded render on a
``(n/2, 2)`` mesh, the mixed scene with boxes, a ``prim=4`` mesh when 4
divides ``n``, one hard fit step and one soft fit step with a reflection.
``run_requests`` renders, fits and counts collectives as a list of requests
says, and returns numpy arrays to the launcher.

    python -m raytracer_tpu_torch.parallel.dryrun 4          # 4 cards, NCCL
    python -m raytracer_tpu_torch.parallel.dryrun 4 --cpu    # the CPU, gloo
"""

from __future__ import annotations

import argparse
import queue as queue_mod
import socket
import time
import traceback

import torch
import torch.distributed as dist

__all__ = ["spawn", "dryrun_multichip", "dryrun_legs", "run_requests"]


def free_port() -> int:
    """A TCP port of 127.0.0.1 that is free now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, fn, args, device, backend, results):
    from raytracer_tpu_torch.parallel.hosts import initialize_distributed

    torch.set_num_threads(1)
    try:
        initialize_distributed(f"127.0.0.1:{port}", world, rank, backend=backend,
                               device=f"cuda:{rank}" if device is None else device)
        results.put((rank, True, fn(*args)))
    except Exception:  # the launcher reports it and ends the other ranks
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world: int, *, args=(), device="cpu", backend: str | None = "gloo",
          timeout_s: float = 120.0) -> list:
    """``fn(*args)`` on ``world`` ranks, each a spawned process in one
    ``backend`` process group on ``device`` (one thread each; ``device=None``
    puts rank ``r`` on ``cuda:r``, and ``backend=None`` takes NCCL on CUDA
    and gloo on the CPU); the ranks' results, by rank. Raises
    ``RuntimeError`` if a rank raises or dies, or if the ranks have not all
    returned within ``timeout_s``; every child is ended before this returns
    or raises."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, port, fn, args, device, backend, results))
             for r in range(world)]
    out = {}
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RuntimeError(f"ranks {sorted(set(range(world)) - set(out))} did not "
                                   f"return within {timeout_s} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if dead:
                    # A rank may exit just after its result is queued; look once more.
                    try:
                        rank, ok, value = results.get(timeout=5.0)
                    except queue_mod.Empty:
                        raise RuntimeError(f"rank {dead[0]} exited with code "
                                           f"{procs[dead[0]].exitcode} and no result") from None
                else:
                    continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
        results.close()
    return [out[r] for r in range(world)]


def _scene(spec, device):
    from raytracer_tpu_torch.models import scenes

    name, args, kwargs = spec
    return getattr(scenes, name)(*args, **kwargs, device=device)


def _finite(name: str, x: torch.Tensor) -> None:
    if not bool(torch.isfinite(x).all()):
        raise RuntimeError(f"{name}: non-finite values")


def dryrun_legs(device="cpu") -> dict:
    """The dry run's legs on this rank (every rank of the process group
    runs them): the sharded render of grid-8 at 64x48 d2 on a ``(n/2, 2)``
    mesh (``(n, 1)`` for odd ``n``), the mixed scene at d1, grid-8 at d1 on
    a ``(n/4, 4)`` mesh when 4 divides ``n``, one hard fit step (d2) and one
    soft fit step with a reflection (grid-4, 32x24, d1). Raises on a wrong
    shape or a non-finite value; returns the two losses."""
    from raytracer_tpu_torch.models import scenes
    from raytracer_tpu_torch.parallel.mesh import make_mesh
    from raytracer_tpu_torch.parallel.render import render_sharded
    from raytracer_tpu_torch.parallel.train import make_fit_step

    n = dist.get_world_size()
    prim = 2 if n % 2 == 0 else 1
    mesh = make_mesh(px=n // prim, prim=prim, device=device)
    mesh4 = make_mesh(px=n // 4, prim=4, device=device) if n % 4 == 0 else None
    width, height, depth = 64, 48, 2
    scene = scenes.grid_sphere_scene(8, distance=4.0, device=device)
    camera = scenes.reference_demo_camera(device=device)

    with torch.no_grad():
        img = render_sharded(scene, camera, width, height, mesh=mesh, depth=depth)
        if img.shape != (height, width, 3):
            raise RuntimeError(f"sharded render: shape {tuple(img.shape)}")
        _finite("sharded render", img)
        _finite("mixed scene", render_sharded(scenes.mixed_primitive_scene(device=device),
                                              camera, width, height, mesh=mesh, depth=1))
        if mesh4 is not None:
            _finite("prim=4 render", render_sharded(scene, camera, width, height, mesh=mesh4,
                                                    depth=1))

    init_fn, step_fn = make_fit_step(width, height, mesh=mesh, depth=depth)
    target = torch.zeros((height, width, 3), device=mesh.device)
    _, loss = step_fn(init_fn(scene), scene, camera, target)
    _finite("hard fit step", loss)

    sw, sh = 32, 24
    scene_s = scenes.grid_sphere_scene(4, distance=4.0, device=device)
    init_s, step_s = make_fit_step(sw, sh, mesh=mesh, depth=1, soft=True)
    _, loss_s = step_s(init_s(scene_s), scene_s, camera,
                       torch.zeros((sh, sw, 3), device=mesh.device))
    _finite("soft fit step", loss_s)
    return {"loss": float(loss), "loss_soft": float(loss_s)}


def dryrun_multichip(n_devices: int, *, device=None, backend: str | None = None,
                     timeout_s: float = 300.0) -> list:
    """``dryrun_legs`` on ``n_devices`` spawned ranks; each rank's losses.

    By default rank ``r`` runs on ``cuda:r`` over NCCL, and this raises when
    there are fewer cards than ranks; ``device="cpu"`` (with ``backend=
    "gloo"``) runs every rank on the CPU."""
    if device is None and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) needs {n_devices} CUDA devices, "
                           f"one a rank; this host has {torch.cuda.device_count()} "
                           "(device='cpu', backend='gloo' runs the ranks on the CPU)")
    return spawn(dryrun_legs, n_devices, args=(device,), device=device, backend=backend,
                 timeout_s=timeout_s)


def _request(req: dict, mesh, device):
    """One request of ``run_requests`` on ``mesh``."""
    from raytracer_tpu_torch.models import scenes
    from raytracer_tpu_torch.parallel import comm
    from raytracer_tpu_torch.parallel.render import (
        render_sharded,
        render_soft_sharded_impl,
    )
    from raytracer_tpu_torch.parallel.train import make_fit_step

    scene = _scene(req["scene"], device)
    if "center" in req:
        center = torch.from_numpy(req["center"]).to(scene.spheres.center.device)
        scene = scene.replace(spheres=scene.spheres.replace(center=center))
    camera = scenes.reference_demo_camera(device=device)
    width, height = req["size"]
    kind = req["kind"]
    if kind in ("render", "soft"):
        with torch.no_grad(), comm.census() as log:
            if kind == "render":
                img = render_sharded(scene, camera, width, height, mesh=mesh,
                                     depth=req["depth"], fold=req.get("fold", "auto"))
            else:
                img = render_soft_sharded_impl(scene, camera, width, height, mesh=mesh,
                                               tau=req["tau"], depth=req["depth"],
                                               tonemap=req.get("tonemap", True))
        return {"image": img.cpu().numpy(), "census": log}
    if kind == "fit":
        soft = req["soft"]
        init_fn, step_fn = make_fit_step(
            width, height, mesh=mesh, depth=req["depth"], soft=soft,
            soft_tau=req.get("tau", 0.01), tonemap=req.get("tonemap", True))
        state = init_fn(scene)
        target = torch.from_numpy(req["target"]).to(mesh.device)
        with comm.census() as log:
            state, loss = step_fn(state, scene, camera, target)
        return {"loss": float(loss), "census": log,
                "params": {k: v.detach().cpu().numpy() for k, v in state.params.items()},
                "grads": {k: v.grad.cpu().numpy() for k, v in state.params.items()}}
    raise ValueError(f"unknown request kind {kind!r}")


def run_requests(device, requests: list) -> list:
    """Each request on this rank, in order: ``{"kind": "render" | "soft" |
    "fit" | "legs", "scene": (factory of models.scenes, args, kwargs),
    "size": (W, H), "depth": d, "mesh": (px, prim), ...}`` (``"fold"`` for
    a render, ``"tau"`` and ``"tonemap"`` for the soft ones, ``"soft"`` and
    the ``"target"`` image for a fit step; ``"center"``, the sphere centres
    in place of the factory's). A render gives its image and the
    collectives it made (``comm.census``), a fit step its loss, the
    updated parameters, the gradients it stepped with (summed over the
    mesh) and its collectives, ``"legs"`` ``dryrun_legs``. A
    mesh is made once per shape, on every rank in the order of first use."""
    from raytracer_tpu_torch.parallel.mesh import make_mesh

    meshes, out = {}, []
    for req in requests:
        if req["kind"] == "legs":
            out.append(dryrun_legs(device))
            continue
        shape = tuple(req["mesh"])
        if shape not in meshes:
            meshes[shape] = make_mesh(*shape, device=device)
        out.append(_request(req, meshes[shape], device))
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="dryrun_multichip on this host's ranks")
    ap.add_argument("n", type=int, nargs="?", default=4, help="ranks (default 4)")
    ap.add_argument("--cpu", action="store_true", help="every rank on the CPU, gloo")
    a = ap.parse_args()
    kw = {"device": "cpu", "backend": "gloo"} if a.cpu else {}
    print(dryrun_multichip(a.n, **kw))
    print(f"dryrun_multichip({a.n}): ok")
