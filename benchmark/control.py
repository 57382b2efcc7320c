"""The control of ``correct``, and the faults a cell can have, as programs
the harness drives in the place of the system under test. Each has to come
out as not correct.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--programs control,half]

runs, for each program named and each seed, one whole run of the cell
(``harness.run_cell``) at the cell's own sizes, with a short window
(``--seconds``: a render run's window renders the frames it compares; a
fit's readings come from its first steps, in set-up), and prints its
checks and ``correct``, then one JSON line of them all. ``control`` is the
plain reference computed in bfloat16, the precision below the
configurations' float32; the others are the program with one fault
planted (``FAULTS``). The benchmark's own runs run none of them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import torch

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import harness  # noqa: E402
from benchmark.reference import common, hard, soft  # noqa: E402

CONTROL_DTYPE = torch.bfloat16


@dataclasses.dataclass
class _State:
    params: dict
    optimizer: torch.optim.Optimizer
    step: int


class ReferenceProgram:
    """The reference in ``dtype`` behind the harness's ``Program``
    interface."""

    def __init__(self, device, dtype=CONTROL_DTYPE):
        self.device, self.dtype = torch.device(device), dtype

    def scene(self, arrays: dict) -> dict:
        return common.to_tensors(arrays, self.device, self.dtype)

    def camera(self, cam: dict) -> dict:
        return common.to_tensors(cam, self.device, self.dtype)

    def render(self, scene, camera, t: dict):
        return hard.render(scene, camera, t["width"], t["height"], t["depth"], tone=t["tonemap"])

    def start(self, truth: dict, params: dict) -> dict:
        return dict(truth, sph_center=params["center"].to(self.dtype),
                    sph_color=params["color"].to(self.dtype))

    def fit_step(self, t: dict):
        def init_fn(scene):
            params = {"center": scene["sph_center"].detach().clone().requires_grad_(True),
                      "color": scene["sph_color"].detach().clone().requires_grad_(True)}
            opt = torch.optim.Adam(list(params.values()), lr=t["learning_rate"],
                                   betas=(0.9, 0.999), eps=1e-8)
            return _State(params, opt, 0)

        def step_fn(state, scene, camera, target):
            args = (scene, state.params, camera, t["width"], t["height"], t["depth"],
                    target.to(self.dtype))
            if t["soft"]:
                loss, _ = soft.loss_and_grads(*args, tau=t["tau"], tau_z=t["tau_z"],
                                              tone=t["tonemap"])
            else:
                loss, _ = hard.loss_and_grads(*args, tone=t["tonemap"])
            state.optimizer.step()
            state.step += 1
            return state, loss

        return init_fn, step_fn


class Frozen(harness.Program):
    """The state left unchanged: every frame is the first one rendered, and
    a fit step takes no optimizer step."""

    first = None

    def render(self, scene, camera, t):
        if self.first is None:
            self.first = super().render(scene, camera, t)
        return self.first

    def fit_step(self, t):
        init_fn, step_fn = super().fit_step(t)

        def frozen(state, scene, camera, target):
            state.optimizer.step = lambda: None
            return step_fn(state, scene, camera, target)
        return init_fn, frozen


class Half(harness.Program):
    """Half of the batch left out: a frame's lower half black; a fit's loss
    the mean over the top half of the rows."""

    def render(self, scene, camera, t):
        img = super().render(scene, camera, t).clone()
        img[img.shape[0] // 2:] = 0.0
        return img

    def fit_step(self, t):
        init_fn, _ = super().fit_step(t)
        rt = self.rt

        def half(state, scene, camera, target):
            state.optimizer.zero_grad(set_to_none=True)
            full = rt.merge_params(scene, state.params)
            if t["soft"]:
                img = rt.render_soft(full, camera, t["width"], t["height"], tau=t["tau"],
                                     tau_z=t["tau_z"], depth=t["depth"], device=self.device)
            else:
                img = rt.render(full, camera, t["width"], t["height"], depth=t["depth"],
                                device=self.device)
            rows = t["height"] // 2
            loss = torch.mean((img[:rows] - target[:rows]) ** 2)
            loss.backward()
            state.optimizer.step()
            state.step += 1
            return state, loss.detach()
        return init_fn, half


class _Hooked(harness.Program):
    """A fit whose leaf ``leaf``'s gradient passes through ``hook`` on its
    way to the optimizer."""

    leaf, hook = "center", None

    def fit_step(self, t):
        init_fn, step_fn = super().fit_step(t)

        def hooked_init(scene):
            state = init_fn(scene)
            state.params[self.leaf].register_hook(self.hook)
            return state
        return hooked_init, step_fn


class Altered(_Hooked):
    """An answer altered where it is made: a frame without its tone map; a
    fit's colours without their gradient."""

    leaf, hook = "color", staticmethod(torch.zeros_like)

    def render(self, scene, camera, t):
        return super().render(scene, camera, dict(t, tonemap=False))


class Scaled(_Hooked):
    """A fit whose centres' gradient reaches the optimizer doubled: Adam's
    first steps move each element by about the learning rate whatever its
    gradient's size, so only the gradient itself shows it."""

    hook = staticmethod(lambda g: 2.0 * g)


FAULTS = {"render": {"frozen": Frozen, "half": Half, "altered": Altered},
          "fit": {"frozen": Frozen, "half": Half, "altered": Altered, "scaled": Scaled}}


def program_named(name: str, kind: str, device):
    if name == "control":
        return ReferenceProgram(device)
    return FAULTS[kind][name](torch.device(device))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--programs", default="control", help="comma-separated: control, "
                    "or a fault of FAULTS")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    spec = harness.load_spec(args.workload)
    kind = spec.traffic["kind"]
    rows = []
    for name in args.programs.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            a = time.perf_counter()
            out = harness.run_cell(spec, seed, args.seconds if kind == "render" else 0.0, False,
                                   "cuda:0", a, program=program_named(name, kind, "cuda:0"))
            r = {"program": name, "seed": seed, "correct": out["correct"],
                 "checks": {k: c["value"] for k, c in out["checks"].items()},
                 "seconds": time.perf_counter() - a}
            print("control", args.workload, json.dumps(r), flush=True)
            rows.append(r)
            torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "device": torch.cuda.get_device_name(0),
                      "runs": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
